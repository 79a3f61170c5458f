"""The plain reference: a straightforward FLAC frame decoder in Python and
NumPy, written from the format specification. It imports nothing of the
program under test and nothing of JAX, and shares no code with the
benchmark's encoder beyond the checksum tables (``gen.crc``).

It decodes what a fixed-blocksize stream can hold: CONSTANT, VERBATIM,
FIXED and LPC subframes, wasted bits, Rice and RICE2 partitions with
escape codes, and the four channel assignments. A frame whose CRC-8 or
CRC-16 does not match raises ``ValueError``.
"""

import operator

import numpy as np

from ..gen.crc import crc8, crc16

__all__ = ["decode_frame", "decode_stream", "read_streaminfo"]

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608, 8: 256, 9: 512,
                10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384,
                15: 32768}
_BPS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class _Bits:
    """MSB-first reader over one frame's bytes."""

    def __init__(self, data):
        self.data = bytes(data)
        self.bits = np.unpackbits(np.frombuffer(self.data, np.uint8))
        self.pos = 0
        self._next_one = None
        #: the longest Rice code read, in bits, a partition's first code
        #: counted with the parameter field before it.
        self.longest = 0

    def read(self, n):
        if n == 0:
            return 0
        a, b = self.pos >> 3, (self.pos + n + 7) >> 3
        if b > len(self.data):
            raise ValueError("frame ends inside a field")
        v = int.from_bytes(self.data[a:b], "big")
        v = (v >> ((b << 3) - self.pos - n)) & ((1 << n) - 1)
        self.pos += n
        return v

    def read_signed(self, n):
        v = self.read(n)
        return v - (1 << n) if n and v >> (n - 1) else v

    def unary(self):
        t = self.next_one()[self.pos]
        if t < 0:
            raise ValueError("frame ends inside a unary code")
        q = t - self.pos
        self.pos = t + 1
        return q

    def next_one(self):
        """next_one()[i]: the first set bit at or after i (-1: none)."""
        if self._next_one is None:
            ones = np.flatnonzero(self.bits)
            idx = np.searchsorted(ones, np.arange(len(self.bits) + 1))
            nxt = np.append(ones, -1)[idx]
            self._next_one = nxt.tolist()
        return self._next_one

    def fields(self, starts, width):
        """The ``width``-bit unsigned fields at each of ``starts``."""
        starts = np.asarray(starts, np.int64)
        if width == 0 or len(starts) == 0:
            return np.zeros(len(starts), np.int64)
        if starts.max() + width > len(self.bits):
            raise ValueError("frame ends inside a residual")
        idx = starts[:, None] + np.arange(width)
        w = (1 << np.arange(width - 1, -1, -1, dtype=np.int64))
        return self.bits[idx].astype(np.int64) @ w


def _rice_partition(r, n, k, lead):
    """``n`` Rice codes with parameter ``k``, as signed int64 (``lead``:
    the bits of the parameter field before the first code)."""
    nxt = r.next_one()
    p = r.pos
    qs = [0] * n
    starts = [0] * n
    for i in range(n):
        t = nxt[p]
        if t < 0:
            raise ValueError("frame ends inside a unary code")
        qs[i] = t - p
        starts[i] = t + 1
        p = t + 1 + k
    r.pos = p
    if n:
        r.longest = max(r.longest, lead + qs[0] + 1 + k, max(qs) + 1 + k)
    u = (np.asarray(qs, np.int64) << k) | r.fields(starts, k)
    return (u >> 1) ^ -(u & 1)


def _residual(r, block_size, order):
    method = r.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    pbits, escape = (4, 15) if method == 0 else (5, 31)
    po = r.read(4)
    per = block_size >> po
    if per << po != block_size or per < order:
        raise ValueError("bad partition order")
    out = []
    for i in range(1 << po):
        n = per - order if i == 0 else per
        k = r.read(pbits)
        if k == escape:
            width = r.read(5)
            vals = [r.read_signed(width) for _ in range(n)]
            out.append(np.asarray(vals, np.int64))
        else:
            out.append(_rice_partition(r, n, k, pbits))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _predict(warm, resid, coefs, shift):
    """s[i] = resid[i] + (sum_j coefs[j] * s[i-1-j]) >> shift."""
    order = len(coefs)
    s = list(warm) + [0] * len(resid)
    rev = list(reversed(coefs))
    mul = operator.mul
    for i, e in enumerate(resid.tolist(), start=order):
        s[i] = e + (sum(map(mul, rev, s[i - order:i])) >> shift)
    return np.asarray(s, np.int64)


_FIXED = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _subframe(r, block_size, bps):
    if r.read(1):
        raise ValueError("subframe padding bit set")
    kind = r.read(6)
    wasted = 0
    if r.read(1):
        wasted = r.unary() + 1
    bps -= wasted
    if kind == 0:
        x = np.full(block_size, r.read_signed(bps), np.int64)
    elif kind == 1:
        x = np.asarray([r.read_signed(bps) for _ in range(block_size)],
                       np.int64)
    elif 8 <= kind <= 12:
        order = kind - 8
        warm = [r.read_signed(bps) for _ in range(order)]
        x = _predict(warm, _residual(r, block_size, order), _FIXED[order], 0)
    elif kind >= 32:
        order = kind - 31
        warm = [r.read_signed(bps) for _ in range(order)]
        precision = r.read(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision")
        shift = r.read_signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = [r.read_signed(precision) for _ in range(order)]
        x = _predict(warm, _residual(r, block_size, order), coefs, shift)
    else:
        raise ValueError("reserved subframe type")
    return x << wasted


def decode_frame(data, stream_bps=None, max_len=None, stats=None):
    """Decode the frame at the start of ``data`` (which it reads no
    further than ``max_len`` bytes into). Returns ((block_size, channels)
    int64 PCM, the frame's length in bytes, its number). A ``stats`` dict
    gets ``longest_code``: the frame's longest Rice code in bits, as
    ``_Bits.longest`` counts it."""
    r = _Bits(data[:len(data) if max_len is None else max_len])
    if r.read(15) != 0x7FFC:
        raise ValueError("no frame sync")
    if r.read(1):
        raise ValueError("variable blocking is not expected here")
    bs_code, sr_code = r.read(4), r.read(4)
    ca, bps_code = r.read(4), r.read(3)
    r.read(1)
    first = r.read(8)
    n_extra = 0
    while n_extra < 7 and (first << n_extra) & 0x80:
        n_extra += 1
    number = first & (0x7F >> n_extra) if n_extra else first
    for _ in range(max(n_extra - 1, 0)):
        number = (number << 6) | (r.read(8) & 0x3F)
    if bs_code == 6:
        block_size = r.read(8) + 1
    elif bs_code == 7:
        block_size = r.read(16) + 1
    elif bs_code in _BLOCK_SIZES:
        block_size = _BLOCK_SIZES[bs_code]
    else:
        raise ValueError("reserved block size")
    if sr_code == 12:
        r.read(8)
    elif sr_code in (13, 14):
        r.read(16)
    bps = _BPS.get(bps_code, stream_bps) if bps_code else stream_bps
    if bps is None:
        raise ValueError("bits per sample unknown")
    head_end = r.pos >> 3
    if r.read(8) != crc8(r.data[:head_end]):
        raise ValueError("frame header CRC-8 mismatch")
    if ca < 8:
        subs = [_subframe(r, block_size, bps) for _ in range(ca + 1)]
        pcm = np.stack(subs, axis=1)
    elif ca <= 10:
        a = _subframe(r, block_size, bps + (ca == 9))
        b = _subframe(r, block_size, bps + (ca != 9))
        if ca == 8:      # left, side
            left, right = a, a - b
        elif ca == 9:    # side, right
            left, right = a + b, b
        else:            # mid, side
            mid = (a << 1) | (b & 1)
            left, right = (mid + b) >> 1, (mid - b) >> 1
        pcm = np.stack([left, right], axis=1)
    else:
        raise ValueError("reserved channel assignment")
    end = (r.pos + 7) >> 3
    if int.from_bytes(r.data[end:end + 2], "big") != crc16(r.data[:end]):
        raise ValueError("frame CRC-16 mismatch")
    if stats is not None:
        stats["longest_code"] = r.longest
    return pcm, end + 2, number


def read_streaminfo(data):
    """(STREAMINFO fields, offset of the first frame)."""
    if bytes(data[:4]) != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos, info = 4, None
    while True:
        head = data[pos]
        length = int.from_bytes(bytes(data[pos + 1:pos + 4]), "big")
        body = bytes(data[pos + 4:pos + 4 + length])
        if head & 0x7F == 0:
            packed = int.from_bytes(body[10:18], "big")
            info = {"min_block": int.from_bytes(body[0:2], "big"),
                    "max_block": int.from_bytes(body[2:4], "big"),
                    "min_frame": int.from_bytes(body[4:7], "big"),
                    "max_frame": int.from_bytes(body[7:10], "big"),
                    "sample_rate": packed >> 44,
                    "channels": ((packed >> 41) & 7) + 1,
                    "bps": ((packed >> 36) & 31) + 1,
                    "samples": packed & ((1 << 36) - 1),
                    "md5": body[18:34]}
        pos += 4 + length
        if head & 0x80:
            return info, pos


def decode_stream(data):
    """(STREAMINFO fields, (samples, channels) int64 PCM) of a whole
    stream, frame by frame; each frame's number must follow the last."""
    info, pos = read_streaminfo(data)
    mv = memoryview(data)
    limit = info["max_frame"] or 1 << 22
    pcms = []
    while pos < len(data):
        pcm, n, number = decode_frame(mv[pos:], info["bps"], limit)
        if number != len(pcms):
            raise ValueError(f"frame {len(pcms)} is numbered {number}")
        pcms.append(pcm)
        pos += n
    pcm = np.concatenate(pcms) if pcms else np.zeros((0, info["channels"]))
    return info, pcm
