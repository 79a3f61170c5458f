"""Frame decoding (a copy of ``claxon_tpu.frame``; reference layer L4a,
claxon `src/frame.rs`).

Frame header parse + CRC-8, per-channel subframe dispatch, stereo
decorrelation, CRC-16 footer verification, the ``Block`` container with its
buffer-recycling move-in/move-out protocol, and ``FrameReader``.

This is the reference-fidelity scalar path (oracle / fallback). Batched
decoding goes through ``claxon_tpu_torch.native`` (the C++ core) feeding
``claxon_tpu_torch.pipeline`` (the CUDA kernels); all paths are
bit-exact.
"""

import numpy as np

from . import subframe
from .error import IoError, Unsupported, fmt_err
from .io.readers import Crc8Reader, Crc16Reader
from .io.bits import Bitstream

__all__ = ["Block", "FrameReader", "read_var_length_int",
           "decode_left_side", "decode_right_side", "decode_mid_side",
           "ensure_buffer_len"]


def read_var_length_int(input):
    """Read a variable-length integer in the spec's "UTF-8"-style coding
    (not real UTF-8), up to 36 bits (reference `src/frame.rs:61-105`)."""
    first = input.read_u8()

    # The number of leading 1s in the first byte determines the number of
    # additional bytes.
    read_additional = 0
    mask_data = 0b0111_1111
    mask_mark = 0b1000_0000
    while first & mask_mark != 0:
        read_additional += 1
        mask_data >>= 1
        mask_mark >>= 1

    if read_additional > 0:
        # A single leading 1 marks a continuation byte; invalid as first byte.
        if read_additional == 1:
            fmt_err("invalid variable-length integer")
        # The number of 1s (if > 1) is the total number of bytes.
        read_additional -= 1

    result = (first & mask_data) << (6 * read_additional)
    for i in range(read_additional - 1, -1, -1):
        byte = input.read_u8()
        # The two most significant bits must be 10.
        if byte & 0b1100_0000 != 0b1000_0000:
            fmt_err("invalid variable-length integer")
        result |= (byte & 0b0011_1111) << (6 * i)

    return result


class FrameHeader:
    """Parsed frame header (reference `src/frame.rs:41-59`).

    ``channel_assignment`` is ``("independent", n)``, ``("left_side", 2)``,
    ``("right_side", 2)`` or ``("mid_side", 2)``. ``block_time`` is
    ``("frame", n)`` or ``("sample", n)``.
    """

    __slots__ = ("block_time", "block_size", "sample_rate",
                 "channel_assignment", "bits_per_sample")

    def __init__(self, block_time, block_size, sample_rate,
                 channel_assignment, bits_per_sample):
        self.block_time = block_time
        self.block_size = block_size
        self.sample_rate = sample_rate
        self.channel_assignment = channel_assignment
        self.bits_per_sample = bits_per_sample

    @property
    def channels(self):
        return self.channel_assignment[1]


def read_frame_header_or_eof(input):
    """Read a frame header, verifying its CRC-8; None on clean EOF.

    ``input`` is typically a ``Crc16Reader``; the CRC-8 wraps it so the
    whole-frame CRC-16 still sees every byte (reference `src/frame.rs:131-316`).
    """
    crc_input = Crc8Reader(input)

    # 14 bits sync code, 1 reserved bit, 1 bit blocking strategy. EOF before
    # these two bytes is a clean end of stream.
    sync_res_block = crc_input.read_be_u16_or_eof()
    if sync_res_block is None:
        return None

    if sync_res_block & 0b1111_1111_1111_1100 != 0b1111_1111_1111_1000:
        fmt_err("frame sync code missing")

    if sync_res_block & 0b0000_0000_0000_0010 != 0:
        fmt_err("invalid frame header, encountered reserved value")

    variable_blocking = (sync_res_block & 1) == 1

    # 4 bits block size code + 4 bits sample rate code.
    bs_sr = crc_input.read_u8()
    bs_code = bs_sr >> 4
    block_size = 0
    read_8bit_bs = read_16bit_bs = False
    if bs_code == 0b0000:
        fmt_err("invalid frame header, encountered reserved value")
    elif bs_code == 0b0001:
        block_size = 192
    elif 0b0010 <= bs_code <= 0b0101:
        block_size = 576 * (1 << (bs_code - 2))
    elif bs_code == 0b0110:
        read_8bit_bs = True
    elif bs_code == 0b0111:
        read_16bit_bs = True
    else:
        block_size = 256 * (1 << (bs_code - 8))

    sr_code = bs_sr & 0b0000_1111
    sample_rate = None
    read_8bit_sr = read_16bit_sr = read_16bit_sr_ten = False
    _SR = {0b0001: 88_200, 0b0010: 176_400, 0b0011: 192_000, 0b0100: 8_000,
           0b0101: 16_000, 0b0110: 22_050, 0b0111: 24_000, 0b1000: 32_000,
           0b1001: 44_100, 0b1010: 48_000, 0b1011: 96_000}
    if sr_code == 0b0000:
        sample_rate = None  # get from streaminfo
    elif sr_code in _SR:
        sample_rate = _SR[sr_code]
    elif sr_code == 0b1100:
        read_8bit_sr = True
    elif sr_code == 0b1101:
        read_16bit_sr = True
    elif sr_code == 0b1110:
        read_16bit_sr_ten = True
    else:
        # Code 1111 is disallowed so a header byte cannot mimic the sync
        # pattern.
        fmt_err("invalid frame header")

    # 4 bits channel assignment, 3 bits sample size, 1 reserved bit.
    chan_bps_res = crc_input.read_u8()
    ca = chan_bps_res >> 4
    if ca < 8:
        channel_assignment = ("independent", ca + 1)
    elif ca == 0b1000:
        channel_assignment = ("left_side", 2)
    elif ca == 0b1001:
        channel_assignment = ("right_side", 2)
    elif ca == 0b1010:
        channel_assignment = ("mid_side", 2)
    else:
        fmt_err("invalid frame header, encountered reserved value")

    bps_code = (chan_bps_res & 0b0000_1110) >> 1
    _BPS = {0b001: 8, 0b010: 12, 0b100: 16, 0b101: 20, 0b110: 24}
    if bps_code == 0b000:
        bits_per_sample = None  # get from streaminfo
    elif bps_code in _BPS:
        bits_per_sample = _BPS[bps_code]
    else:
        fmt_err("invalid frame header, encountered reserved value")

    if chan_bps_res & 1 != 0:
        fmt_err("invalid frame header, encountered reserved value")

    if variable_blocking:
        # Sample number: at most a 36-bit int.
        block_time = ("sample", read_var_length_int(crc_input))
    else:
        # Frame number: at most a 31-bit int.
        frame = read_var_length_int(crc_input)
        if frame > 0x7FFFFFFF:
            fmt_err("invalid frame header, frame number too large")
        block_time = ("frame", frame)

    if read_8bit_bs:
        block_size = crc_input.read_u8() + 1
    if read_16bit_bs:
        bs = crc_input.read_be_u16()
        # 0xffff would exceed the 16-bit max block size in the streaminfo.
        if bs == 0xFFFF:
            fmt_err("invalid block size, exceeds 65535")
        block_size = bs + 1

    if read_8bit_sr:
        sample_rate = crc_input.read_u8()
    if read_16bit_sr:
        sample_rate = crc_input.read_be_u16()
    if read_16bit_sr_ten:
        sample_rate = crc_input.read_be_u16() * 10

    # An 8-bit CRC over the entire header.
    computed_crc = crc_input.crc
    presumed_crc = crc_input.read_u8()
    if computed_crc != presumed_crc:
        fmt_err("frame header CRC mismatch")

    return FrameHeader(block_time, block_size, sample_rate,
                       channel_assignment, bits_per_sample)


def decode_left_side(buffer):
    """In-place left ++ side -> left ++ right (reference `src/frame.rs:318-334`).

    side = left - right, so right = left - side. Wrapping subtract: a valid
    file never overflows; an invalid one decodes garbage without crashing.
    """
    n = buffer.shape[0] // 2
    left = buffer[:n]
    side = buffer[n:]
    np.subtract(left, side, out=side)  # int32 wraps


def decode_right_side(buffer):
    """In-place side ++ right -> left ++ right (reference `src/frame.rs:344-360`)."""
    n = buffer.shape[0] // 2
    side = buffer[:n]
    right = buffer[n:]
    np.add(side, right, out=side)  # left = side + right, int32 wraps


def decode_mid_side(buffer):
    """In-place mid ++ side -> left ++ right (reference `src/frame.rs:370-389`).

    Doubles mid and restores the rounding bit from side's parity:
    mid' = mid * 2 | (side & 1); left = (mid' + side) / 2;
    right = (mid' - side) / 2. mid' +- side is always even (the parities
    match), so the truncating division is an arithmetic shift.
    """
    n = buffer.shape[0] // 2
    mid = buffer[:n]
    side = buffer[n:]
    mid2 = ((mid * np.int32(2)) | (side & np.int32(1)))  # wraps like the reference
    np.right_shift(mid2 + side, 1, out=mid)
    np.right_shift(mid2 - side, 1, out=side)


class Block:
    """A block of raw audio samples (reference `src/frame.rs:401-529`).

    Owns a numpy int32 buffer with the channels stored consecutively. The
    buffer can be recycled: pass ``block.into_buffer()`` back into
    ``FrameReader.read_next_or_eof`` to decode the next frame without
    allocating.
    """

    __slots__ = ("_first_sample_number", "_block_size", "_channels", "_buffer")

    def __init__(self, time, block_size, buffer):
        self._first_sample_number = time
        self._block_size = block_size
        self._channels = (buffer.shape[0] // block_size) if block_size else 0
        self._buffer = buffer

    @staticmethod
    def empty():
        """A block with 0 channels and 0 samples."""
        return Block(0, 0, np.empty(0, dtype=np.int32))

    def time(self):
        """Inter-channel sample number of the first sample in this block."""
        return self._first_sample_number

    def len(self):
        """Total number of samples; channels count separately."""
        return self._block_size * self._channels

    def duration(self):
        """Number of inter-channel samples (the block size)."""
        return self._block_size

    def channels(self):
        """Number of channels."""
        return self._channels

    def channel(self, ch):
        """The zero-based ``ch``-th channel as an int32 array view."""
        bsz = self._block_size
        return self._buffer[ch * bsz:(ch + 1) * bsz]

    def sample(self, ch, sample):
        """Sample ``sample`` of channel ``ch`` (both zero-based)."""
        return int(self._buffer[ch * self._block_size + sample])

    def into_buffer(self):
        """Return the underlying buffer for reuse. May be larger than
        ``len()``."""
        return self._buffer

    def stereo_samples(self):
        """Iterate (left, right) pairs. Only valid for 2-channel blocks."""
        if self._channels != 2:
            raise AssertionError(
                "stereo_samples() must only be called for blocks with two channels.")
        bsz = self._block_size
        buf = self._buffer
        left = buf[:bsz]
        right = buf[bsz:2 * bsz]
        return zip(left.tolist(), right.tolist())


def ensure_buffer_len(buffer, new_len):
    """Return an int32 buffer of exactly ``new_len`` samples, reusing
    ``buffer``'s storage when possible (reference `src/frame.rs:616-637`).

    Contents are unspecified; the decoder overwrites every element.
    """
    if buffer is None:
        return np.zeros(new_len, dtype=np.int32)
    if buffer.shape[0] < new_len:
        base = buffer.base if buffer.base is not None else buffer
        if base.shape[0] >= new_len:
            return base[:new_len]
        return np.zeros(new_len, dtype=np.int32)
    if buffer.shape[0] > new_len:
        return buffer[:new_len]
    return buffer


class FrameReader:
    """Reads and decodes frames from a byte reader
    (reference `src/frame.rs:599-785`).

    When the C++ core is built and the input is one of this package's
    in-memory or buffered readers, frames decode through the native
    single-frame entry (same CRC checks, same errors, bit-exact) at native
    speed; any other reader, or ``use_native=False``, uses the
    reference-fidelity Python path.
    """

    def __init__(self, input, use_native=None):
        self.input = input
        if use_native is None:
            import os
            use_native = not os.environ.get("CLAXON_TPU_NO_NATIVE_READER")
        self._use_native = use_native

    def _native_mod(self):
        if not self._use_native:
            return None
        try:
            from . import native
            return native if native.available() else None
        except ImportError:
            return None

    def _read_next_native(self, buffer, native):
        """Decode one frame via the C++ core, windowing buffered inputs."""
        from .io.readers import BufferedReader, MemReader

        if isinstance(self.input, MemReader):
            inp = self.input
            window = memoryview(inp._data)[inp.pos:]
            consumed, fbuf, pcm = native.decode_frames_limited(window, 1)
            inp.pos += consumed
        else:
            # BufferedReader: grow its window until one frame fits. The
            # window lives on the reader so a second FrameReader/samples()
            # call continues exactly where the first stopped.
            window = self.input.native_window
            grow = 65536
            while True:
                try:
                    consumed, fbuf, pcm = native.decode_frames_limited(
                        bytes(window), 1)
                except IoError:
                    chunk = self.input.read_up_to(grow)
                    if not chunk:
                        raise  # genuine mid-frame end of stream
                    window += chunk
                    # Double the growth so a huge frame costs O(n) total
                    # window re-parses, not O(n^2).
                    grow = min(grow * 2, 1 << 22)
                    continue
                if len(fbuf) == 0:
                    # Window ends at a frame boundary; clean EOF only if
                    # the stream really is exhausted.
                    chunk = self.input.read_up_to(grow)
                    if not chunk:
                        return None
                    window += chunk
                    continue
                break
            del window[:consumed]

        if len(fbuf) == 0:
            return None
        bs = int(fbuf["block_size"][0])
        nch = int(fbuf["channels"][0])
        buffer = ensure_buffer_len(buffer, bs * nch)
        # Native pcm is interleaved; Block stores channels consecutively.
        np.copyto(buffer[:bs * nch].reshape(nch, bs),
                  pcm.reshape(bs, nch).T)
        return Block(int(fbuf["time"][0]), bs, buffer)

    def read_next_or_eof(self, buffer=None):
        """Decode the next frame into ``buffer``; returns a ``Block`` or
        None at a clean EOF. The buffer is moved into the block; retrieve it
        with ``block.into_buffer()`` (reference `src/frame.rs:667-779`)."""
        native = self._native_mod()
        if native is not None:
            from .io.readers import BufferedReader, MemReader
            if isinstance(self.input, (MemReader, BufferedReader)):
                return self._read_next_native(buffer, native)
        crc_input = Crc16Reader(self.input)
        header = read_frame_header_or_eof(crc_input)
        if header is None:
            return None

        total_samples = header.channels * header.block_size
        buffer = ensure_buffer_len(buffer, total_samples)

        if header.bits_per_sample is None:
            raise Unsupported("header without bits per sample info")
        bps = header.bits_per_sample

        bits = Bitstream(crc_input)
        bs = header.block_size
        kind = header.channel_assignment[0]

        # Decode subframes into plain Python lists (arbitrary precision is
        # the simplest route to the reference's exact wrapping semantics),
        # then place them into the numpy buffer for the decorrelation.
        if kind == "independent":
            n_ch = header.channels
            work = [0] * bs
            for ch in range(n_ch):
                subframe.decode(bits, bps, work)
                buffer[ch * bs:(ch + 1) * bs] = work
        else:
            ch0 = [0] * bs
            ch1 = [0] * bs
            if kind == "left_side":
                subframe.decode(bits, bps, ch0)
                subframe.decode(bits, bps + 1, ch1)
            elif kind == "right_side":
                subframe.decode(bits, bps + 1, ch0)
                subframe.decode(bits, bps, ch1)
            else:  # mid_side
                subframe.decode(bits, bps, ch0)
                subframe.decode(bits, bps + 1, ch1)
            buffer[:bs] = ch0
            buffer[bs:2 * bs] = ch1
            if kind == "left_side":
                decode_left_side(buffer[:2 * bs])
            elif kind == "right_side":
                decode_right_side(buffer[:2 * bs])
            else:
                decode_mid_side(buffer[:2 * bs])

        # Dropping the bitstream realigns to a byte boundary (the underlying
        # reader only ever saw whole bytes). The frame footer is a 16-bit CRC
        # over everything up to here.
        computed_crc = crc_input.crc
        presumed_crc = crc_input.read_be_u16()
        if computed_crc != presumed_crc:
            fmt_err("frame CRC mismatch")

        strategy, value = header.block_time
        time = header.block_size * value if strategy == "frame" else value

        return Block(time, header.block_size, buffer)

    def into_inner(self):
        """Return the wrapped reader."""
        return self.input
