"""In-memory byte reader for the metadata parse (a copy of
``claxon_tpu.io.readers``' ``_ReadBytesBase`` and ``MemReader``; reference
layer L0, claxon `src/input.rs:24-278`).

The ``ReadBytes`` protocol is a duck type; any object with these methods
works as input to the metadata decoder:

    read_u8() -> int              raise IoError at EOF
    read_u8_or_eof() -> int|None  None at EOF
    read_into(n) -> bytes         exactly n bytes or IoError
    skip(n)                       skip n bytes or IoError
    read_be_u16() / read_be_u16_or_eof() / read_be_u24() / read_be_u32()
    read_le_u32()

The port reads whole streams from memory, so the buffered file reader and
the CRC-computing decorators are not carried over.
"""

from .error import IoError

__all__ = ["MemReader"]

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


class MemReader(_ReadBytesBase):
    """Cursor over an in-memory bytes-like object.

    Counterpart of the reference's ``io::Cursor`` impl
    (`src/input.rs:234-278`).
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
