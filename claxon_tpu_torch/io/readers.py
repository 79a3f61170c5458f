"""Byte-level input readers (a copy of ``claxon_tpu.io.readers``; reference
layer L0, claxon `src/input.rs:24-278`).

The ``ReadBytes`` protocol is a duck type; any object with these methods
works as input to the metadata and frame decoders:

    read_u8() -> int              raise IoError at EOF
    read_u8_or_eof() -> int|None  None at EOF
    read_into(n) -> bytes         exactly n bytes or IoError
    skip(n)                       skip n bytes or IoError
    read_be_u16() / read_be_u16_or_eof() / read_be_u24() / read_be_u32()
    read_le_u32()

This protocol is what lets the same frame decoder run over a buffered file
(normal path), an in-memory cursor (Ogg packets, MP4 chunks, tests), or a
CRC-computing wrapper -- the same seam the reference uses for test input
injection (`src/input.rs:71-128,234-278`).
"""

from ..error import IoError
from ..crc import CRC8_TABLE, CRC16_TABLE

_EOF_MSG = "unexpected end of stream"


class _ReadBytesBase:
    """Default implementations of the multi-byte reads, in terms of read_u8.

    Subclasses override whatever they can do faster.
    """

    def read_u8(self):
        raise NotImplementedError

    def read_u8_or_eof(self):
        raise NotImplementedError

    def read_into(self, n):
        raise NotImplementedError

    def skip(self, n):
        raise NotImplementedError

    def read_be_u16(self):
        b0 = self.read_u8()
        b1 = self.read_u8()
        return (b0 << 8) | b1

    def read_be_u16_or_eof(self):
        # EOF at EITHER byte is a clean None, like the reference
        # (`src/input.rs:93-100`): a stream ending one byte into a
        # would-be frame header is a clean end of stream.
        b0 = self.read_u8_or_eof()
        if b0 is None:
            return None
        b1 = self.read_u8_or_eof()
        if b1 is None:
            return None
        return (b0 << 8) | b1

    def read_be_u24(self):
        b0 = self.read_u8()
        b1 = self.read_u8()
        b2 = self.read_u8()
        return (b0 << 16) | (b1 << 8) | b2

    def read_be_u32(self):
        b0 = self.read_u8()
        b1 = self.read_u8()
        b2 = self.read_u8()
        b3 = self.read_u8()
        return (b0 << 24) | (b1 << 16) | (b2 << 8) | b3

    def read_le_u32(self):
        b0 = self.read_u8()
        b1 = self.read_u8()
        b2 = self.read_u8()
        b3 = self.read_u8()
        return (b3 << 24) | (b2 << 16) | (b1 << 8) | b0


class BufferedReader(_ReadBytesBase):
    """Buffered byte reader over a binary file-like object.

    The reference uses a custom buffered reader (2048-byte buffer) instead of
    ``BufRead`` so a CRC can be computed on consume (`src/input.rs:18-67`).
    Here buffering mainly amortizes Python call overhead into the stream.
    """

    __slots__ = ("_stream", "_buf", "_pos", "_size", "native_window")

    def __init__(self, stream, buffer_size=8192):
        self._stream = stream
        self._size = buffer_size
        self._buf = b""
        self._pos = 0
        #: lookahead window of the native FrameReader fast path (bytes
        #: pulled from the stream but not yet decoded); kept on the reader
        #: so stacked FrameReaders continue frame-aligned.
        self.native_window = bytearray()

    def read_up_to(self, n):
        """Up to ``n`` raw bytes for the native fast path: drains the
        internal buffer first, then reads the stream once. b'' at EOF."""
        if self._pos < len(self._buf):
            chunk = self._buf[self._pos:]
            self._pos = len(self._buf)
            return chunk
        return self._stream.read(n) or b""

    def _refill(self):
        self._buf = self._stream.read(self._size)
        self._pos = 0
        return len(self._buf) > 0

    def read_u8(self):
        if self._pos >= len(self._buf):
            if not self._refill():
                raise IoError(_EOF_MSG)
        b = self._buf[self._pos]
        self._pos += 1
        return b

    def read_u8_or_eof(self):
        if self._pos >= len(self._buf):
            if not self._refill():
                return None
        b = self._buf[self._pos]
        self._pos += 1
        return b

    def read_into(self, n):
        parts = []
        remaining = n
        while remaining > 0:
            avail = len(self._buf) - self._pos
            if avail == 0:
                if not self._refill():
                    raise IoError(_EOF_MSG)
                avail = len(self._buf)
            take = min(avail, remaining)
            parts.append(self._buf[self._pos:self._pos + take])
            self._pos += take
            remaining -= take
        return b"".join(parts)

    def skip(self, n):
        remaining = n
        while remaining > 0:
            avail = len(self._buf) - self._pos
            if avail == 0:
                if not self._refill():
                    raise IoError(_EOF_MSG)
                avail = len(self._buf)
            take = min(avail, remaining)
            self._pos += take
            remaining -= take

    def into_inner(self):
        """Return the wrapped stream. Anything buffered is lost."""
        return self._stream


class MemReader(_ReadBytesBase):
    """Cursor over an in-memory bytes-like object.

    Counterpart of the reference's ``io::Cursor`` impl
    (`src/input.rs:234-278`); used for Ogg packets, MP4 chunks and tests.
    """

    __slots__ = ("_data", "pos")

    def __init__(self, data, pos=0):
        self._data = bytes(data)
        self.pos = pos

    def read_u8(self):
        d, p = self._data, self.pos
        if p >= len(d):
            raise IoError(_EOF_MSG)
        self.pos = p + 1
        return d[p]

    def read_u8_or_eof(self):
        d, p = self._data, self.pos
        if p >= len(d):
            return None
        self.pos = p + 1
        return d[p]

    def read_into(self, n):
        d, p = self._data, self.pos
        if p + n > len(d):
            raise IoError(_EOF_MSG)
        self.pos = p + n
        return d[p:p + n]

    def skip(self, n):
        if self.pos + n > len(self._data):
            raise IoError(_EOF_MSG)
        self.pos += n

    def read_be_u16(self):
        d, p = self._data, self.pos
        if p + 2 > len(d):
            raise IoError(_EOF_MSG)
        self.pos = p + 2
        return (d[p] << 8) | d[p + 1]

    def into_inner(self):
        return self._data


class Crc8Reader(_ReadBytesBase):
    """Decorator reader computing a CRC-8 over every byte read.

    Used for the frame header checksum (reference `src/crc.rs:59-106`).
    ``read_into``/``skip`` are deliberately forbidden: skipped bytes would
    corrupt the checksum (reference `src/crc.rs:138-144`).
    """

    __slots__ = ("inner", "crc")

    def __init__(self, inner):
        self.inner = inner
        self.crc = 0

    def read_u8(self):
        b = self.inner.read_u8()
        self.crc = int(CRC8_TABLE[self.crc ^ b])
        return b

    def read_u8_or_eof(self):
        b = self.inner.read_u8_or_eof()
        if b is not None:
            self.crc = int(CRC8_TABLE[self.crc ^ b])
        return b

    def read_into(self, n):
        raise AssertionError("read_into should not be used through a CRC reader")

    def skip(self, n):
        raise AssertionError("skip should not be used through a CRC reader")


class Crc16Reader(_ReadBytesBase):
    """Decorator reader computing a CRC-16 over every byte read.

    Used for the whole-frame checksum (reference `src/crc.rs:108-177`).
    """

    __slots__ = ("inner", "crc")

    def __init__(self, inner):
        self.inner = inner
        self.crc = 0

    def read_u8(self):
        b = self.inner.read_u8()
        self.crc = int(CRC16_TABLE[((self.crc >> 8) ^ b) & 0xFF]) ^ ((self.crc << 8) & 0xFFFF)
        return b

    def read_u8_or_eof(self):
        b = self.inner.read_u8_or_eof()
        if b is not None:
            self.crc = int(CRC16_TABLE[((self.crc >> 8) ^ b) & 0xFF]) ^ ((self.crc << 8) & 0xFFFF)
        return b

    def read_into(self, n):
        raise AssertionError("read_into should not be used through a CRC reader")

    def skip(self, n):
        raise AssertionError("skip should not be used through a CRC reader")
