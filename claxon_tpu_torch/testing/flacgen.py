"""A spec-derived FLAC encoder for generating test/bench corpora (a copy of
``claxon_tpu.testing.flacgen``; its output is byte-identical).

Written directly from the FLAC format specification (the same format the
reference *decodes*; this is not a port of anything -- the reference has no
encoder). It produces subset and non-subset streams exercising every decode
path: CONSTANT/VERBATIM/FIXED(0-4)/LPC(1-32) subframes, Rice and Rice2
partitioned residuals with any partition order, wasted bits, all four
channel assignments, 8/12/16/20/24-bit depths, fixed and variable blocking,
and metadata (STREAMINFO with genuine PCM MD5, Vorbis comments, padding,
application and seektable blocks).

The emitted MD5 makes every generated file self-verifying: a decoder that
reproduces the MD5 is bit-exact.
"""

import hashlib
import struct

import numpy as np

from ..crc import crc8, crc16

__all__ = ["encode_flac", "synth_music", "BitWriter"]


class BitWriter:
    """MSB-first bit accumulator."""

    def __init__(self):
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value, bits):
        if bits == 0:
            return
        self._acc = (self._acc << bits) | (value & ((1 << bits) - 1))
        self._nbits += bits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_unary(self, q):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def getvalue(self):
        assert self._nbits == 0
        return bytes(self._out)


def _utf8_like(value):
    """Encode the frame/sample number in the spec's UTF-8-style coding
    (up to 36 bits, up to 7 bytes)."""
    assert 0 <= value < (1 << 36), "frame/sample number exceeds 36 bits"
    if value < 0x80:
        return bytes([value])
    for total in range(2, 8):
        if value < (1 << (5 * total + 1)):
            break
    out = bytearray()
    first_data_bits = 7 - total
    marker = (0xFF << (first_data_bits + 1)) & 0xFF
    out.append(marker | (value >> (6 * (total - 1))))
    for i in range(total - 2, -1, -1):
        out.append(0x80 | ((value >> (6 * i)) & 0x3F))
    return bytes(out)


def _zigzag(v):
    return (v << 1) if v >= 0 else (-(v << 1) - 1)


_BLOCK_SIZE_CODES = {192: 0b0001, 576: 0b0010, 1152: 0b0011, 2304: 0b0100,
                     4608: 0b0101, 256: 0b1000, 512: 0b1001, 1024: 0b1010,
                     2048: 0b1011, 4096: 0b1100, 8192: 0b1101, 16384: 0b1110,
                     32768: 0b1111}
_SAMPLE_RATE_CODES = {88200: 0b0001, 176400: 0b0010, 192000: 0b0011,
                      8000: 0b0100, 16000: 0b0101, 22050: 0b0110,
                      24000: 0b0111, 32000: 0b1000, 44100: 0b1001,
                      48000: 0b1010, 96000: 0b1011}
_BPS_CODES = {8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101, 24: 0b110}


def _fixed_residual(x, order):
    """Residual after the order-k fixed predictor: k-th difference."""
    r = x
    for _ in range(order):
        r = r[1:] - r[:-1]
    return r


def _best_rice_param(resid, max_param):
    """Pick the Rice parameter minimizing the encoded size estimate."""
    if len(resid) == 0:
        return 0
    u = np.where(resid >= 0, resid.astype(np.int64) * 2,
                 -2 * resid.astype(np.int64) - 1)
    mean = max(1, int(u.mean()))
    p = max(0, min(max_param, mean.bit_length() - 1))
    # Refine around the estimate.
    best_p, best_cost = p, None
    for cand in range(max(0, p - 1), min(max_param, p + 2) + 1):
        cost = int((u >> cand).sum()) + len(u) * (cand + 1)
        if best_cost is None or cost < best_cost:
            best_p, best_cost = cand, cost
    return best_p


def _quantize_lpc(coefs_float, precision):
    """Quantize float LPC coefficients to `precision`-bit ints + shift."""
    cmax = np.abs(coefs_float).max()
    if cmax <= 0:
        return None
    # Largest shift (0..15 fits 5-bit non-negative) keeping coefs in range.
    shift = 15
    while shift > 0 and cmax * (1 << shift) >= (1 << (precision - 1)) - 1:
        shift -= 1
    q = np.round(coefs_float * (1 << shift)).astype(np.int64)
    lim = (1 << (precision - 1)) - 1
    q = np.clip(q, -lim - 1, lim)
    if not q.any():
        return None
    return q, shift


def _lpc_coefficients(x, order):
    """Levinson-Durbin on the autocorrelation of the (windowed) signal."""
    n = len(x)
    if n <= order:
        return None
    xf = x.astype(np.float64)
    xf = xf * np.hanning(n)
    auto = np.array([np.dot(xf[:n - k], xf[k:]) for k in range(order + 1)])
    if auto[0] == 0:
        return None
    err = auto[0]
    coefs = np.zeros(order)
    for i in range(order):
        acc = auto[i + 1] - np.dot(coefs[:i], auto[i:0:-1][:i])
        k = acc / err
        coefs[i] = k
        coefs[:i] = coefs[:i] - k * coefs[i - 1::-1][:i]
        err *= (1 - k * k)
        if err <= 0:
            return None
    return coefs  # prediction: x[t] ~= sum coefs[j] * x[t-1-j]


def _encode_residual(bw, resid, block_size, order, partition_order, rice2):
    """Encode the partitioned Rice residual section."""
    bw.write(0b01 if rice2 else 0b00, 2)
    bw.write(partition_order, 4)
    n_partitions = 1 << partition_order
    per = block_size >> partition_order
    max_param = 30 if rice2 else 14
    param_bits = 5 if rice2 else 4
    pos = 0
    for p in range(n_partitions):
        length = per - order if p == 0 else per
        chunk = resid[pos:pos + length]
        pos += length
        param = _best_rice_param(chunk, max_param)
        bw.write(param, param_bits)
        for v in chunk:
            u = _zigzag(int(v))
            bw.write_unary(u >> param)
            bw.write(u, param)


def _encode_subframe(bw, samples, bps, force=None, max_lpc_order=8,
                     partition_order=0, rice2=False, lpc_precision=14,
                     allow_wasted=True):
    """Encode one channel's subframe. ``samples`` is an int64 numpy array."""
    n = len(samples)
    x = samples.astype(np.int64)

    # Wasted bits: common trailing zeros (capped so sf_bps stays >= 1).
    wasted = 0
    if allow_wasted and np.any(x):
        ors = int(np.bitwise_or.reduce(x))
        wasted = min((ors & -ors).bit_length() - 1, bps - 1) if ors else 0
        if wasted > 0:
            x = x >> wasted
    sf_bps = bps - wasted

    def write_header(type_code):
        bw.write(0, 1)
        bw.write(type_code, 6)
        if wasted > 0:
            bw.write(1, 1)
            bw.write_unary(wasted - 1)
        else:
            bw.write(0, 1)

    kind = force
    if kind is None:
        if np.all(x == x[0]):
            kind = "constant"
        else:
            kind = "lpc" if max_lpc_order > 0 and n > max_lpc_order * 2 else "fixed"

    if kind == "constant":
        assert np.all(x == x[0])
        write_header(0)
        bw.write(int(x[0]), sf_bps)
        return

    if kind == "verbatim":
        write_header(1)
        for v in x:
            bw.write(int(v), sf_bps)
        return

    if kind == "fixed":
        # Pick the fixed order with the smallest absolute residual sum.
        best_order, best_cost = 0, None
        for order in range(min(4, n - 1) + 1):
            cost = int(np.abs(_fixed_residual(x, order)).sum())
            if best_cost is None or cost < best_cost:
                best_order, best_cost = order, cost
        order = best_order
        resid = _fixed_residual(x, order)
        write_header(0b001000 | order)
        for v in x[:order]:
            bw.write(int(v), sf_bps)
        _encode_residual(bw, resid, n, order, partition_order, rice2)
        return

    assert kind == "lpc"
    order = min(max_lpc_order, 32, n - 1)
    quant = None
    if order >= 1:
        cf = _lpc_coefficients(x, order)
        if cf is not None:
            quant = _quantize_lpc(cf, lpc_precision)
    if quant is None:
        # Degenerate signal: fall back to fixed order 1.
        _encode_subframe(bw, samples, bps, force="fixed",
                         partition_order=partition_order, rice2=rice2,
                         allow_wasted=allow_wasted)
        return
    q, shift = quant
    # Prediction uses coefficients newest-first in the stream; resid:
    # r[t] = x[t] - ((sum_j q[j] * x[t-1-j]) >> shift), exact ints.
    pred = np.zeros(n - order, dtype=np.int64)
    for j in range(order):
        pred += q[j] * x[order - 1 - j:n - 1 - j]
    resid = x[order:] - (pred >> shift)
    write_header(0b100000 | (order - 1))
    for v in x[:order]:
        bw.write(int(v), sf_bps)
    bw.write(lpc_precision - 1, 4)
    bw.write(shift, 5)
    for j in range(order):
        bw.write(int(q[j]), lpc_precision)
    _encode_residual(bw, resid, n, order, partition_order, rice2)


def encode_flac(pcm, sample_rate, bps, block_size=4096, stereo="auto",
                force_subframe=None, max_lpc_order=8, partition_order=2,
                rice2=False, vendor="claxon_tpu flacgen 0.1", tags=(),
                padding=None, application=None, seektable_points=0,
                variable_blocking=False, lpc_precision=14,
                allow_wasted=True):
    """Encode ``pcm`` (numpy int array of shape (n, channels)) into a FLAC
    stream (bytes). The STREAMINFO block carries the true PCM MD5."""
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, channels = pcm.shape
    assert 1 <= channels <= 8
    lim = 1 << (bps - 1)
    if n:
        assert pcm.min() >= -lim and pcm.max() < lim, "pcm exceeds bps range"
    pcm = pcm.astype(np.int64)

    # ---- audio frames ----
    frames = bytearray()
    min_fs = max_fs = None
    pos = 0
    frame_number = 0
    min_bs = max_bs = None
    while pos < n:
        bs = min(block_size, n - pos)
        chunk = pcm[pos:pos + bs]
        fr = _encode_frame(chunk, sample_rate, bps, stereo, force_subframe,
                           max_lpc_order, partition_order, rice2,
                           frame_number if not variable_blocking else pos,
                           variable_blocking, lpc_precision, allow_wasted)
        frames += fr
        min_fs = len(fr) if min_fs is None else min(min_fs, len(fr))
        max_fs = len(fr) if max_fs is None else max(max_fs, len(fr))
        # Spec (RFC 9639): min/max block size EXCLUDE the short last block.
        if pos + bs < n or bs == block_size:
            min_bs = bs if min_bs is None else min(min_bs, bs)
            max_bs = bs if max_bs is None else max(max_bs, bs)
        pos += bs
        frame_number += 1
        if not variable_blocking:
            assert frame_number <= 0x7FFFFFFF, "frame number exceeds 31 bits"

    # ---- MD5 of the unencoded PCM ----
    nbytes = (bps + 7) // 8
    raw = np.ascontiguousarray(pcm.reshape(-1), dtype="<i8").tobytes()
    md5 = hashlib.md5(
        np.frombuffer(raw, np.uint8).reshape(-1, 8)[:, :nbytes].tobytes()
    ).digest()

    # ---- metadata ----
    out = bytearray(b"fLaC")
    blocks = []

    si = bytearray()
    si += struct.pack(">HH", max(min_bs or 16, 16), max(max_bs or 16, 16))
    si += (min_fs or 0).to_bytes(3, "big")
    si += (max_fs or 0).to_bytes(3, "big")
    packed = (sample_rate << 44) | ((channels - 1) << 41) | ((bps - 1) << 36) | n
    si += packed.to_bytes(8, "big")
    si += md5
    blocks.append((0, bytes(si)))

    if seektable_points:
        # Placeholder seek points (sample number all-ones) are the spec's
        # way to reserve table space without claiming real offsets; the
        # decoder under test skips SEEKTABLE either way.
        st = bytearray()
        for _ in range(seektable_points):
            st += struct.pack(">QQH", 0xFFFFFFFFFFFFFFFF, 0, 0)
        blocks.append((3, bytes(st)))

    if application is not None:
        app_id, app_data = application
        blocks.append((2, struct.pack(">I", app_id) + app_data))

    if vendor is None and tags:
        vendor = ""  # tags require a Vorbis comment block; empty vendor
    if vendor is not None:
        vc = struct.pack("<I", len(vendor.encode())) + vendor.encode()
        vc += struct.pack("<I", len(tags))
        for name, value in tags:
            c = f"{name}={value}".encode()
            vc += struct.pack("<I", len(c)) + c
        blocks.append((4, bytes(vc)))

    if padding is not None:
        blocks.append((1, b"\x00" * padding))

    for i, (btype, body) in enumerate(blocks):
        is_last = i == len(blocks) - 1
        out.append((0x80 if is_last else 0) | btype)
        out += len(body).to_bytes(3, "big")
        out += body

    out += frames
    return bytes(out)


def _encode_frame(chunk, sample_rate, bps, stereo, force_subframe,
                  max_lpc_order, partition_order, rice2, number,
                  variable_blocking, lpc_precision, allow_wasted):
    bs, channels = chunk.shape

    mode = stereo
    if channels != 2:
        mode = "independent"
    elif mode == "auto":
        mode = "mid_side"

    header = bytearray()
    header += struct.pack(">H", 0xFFF9 if variable_blocking else 0xFFF8)

    bs_code = _BLOCK_SIZE_CODES.get(bs)
    bs_tail = b""
    if bs_code is None:
        if bs <= 256:
            bs_code = 0b0110
            bs_tail = bytes([bs - 1])
        else:
            bs_code = 0b0111
            bs_tail = struct.pack(">H", bs - 1)
    sr_code = _SAMPLE_RATE_CODES.get(sample_rate)
    sr_tail = b""
    if sr_code is None:
        if sample_rate % 10 == 0 and sample_rate // 10 <= 0xFFFF:
            sr_code = 0b1110
            sr_tail = struct.pack(">H", sample_rate // 10)
        elif sample_rate <= 0xFFFF:
            sr_code = 0b1101
            sr_tail = struct.pack(">H", sample_rate)
        else:
            sr_code = 0b0000
    header.append((bs_code << 4) | sr_code)

    ca_code = {"independent": channels - 1, "left_side": 0b1000,
               "right_side": 0b1001, "mid_side": 0b1010}[mode]
    bps_code = _BPS_CODES[bps]
    header.append((ca_code << 4) | (bps_code << 1))

    header += _utf8_like(number)
    header += bs_tail
    header += sr_tail
    header.append(crc8(header))

    bw = BitWriter()

    if mode == "independent":
        subchannels = [(chunk[:, c], bps) for c in range(channels)]
    else:
        left = chunk[:, 0]
        right = chunk[:, 1]
        side = left - right
        if mode == "left_side":
            subchannels = [(left, bps), (side, bps + 1)]
        elif mode == "right_side":
            subchannels = [(side, bps + 1), (right, bps)]
        else:
            mid = (left + right) >> 1
            subchannels = [(mid, bps), (side, bps + 1)]

    for x, ch_bps in subchannels:
        po = partition_order
        # The first partition must still fit the warm-up samples; fixed
        # subframes may pick order up to 4 regardless of max_lpc_order.
        order_guess = max(max_lpc_order, 4)
        while po > 0 and (bs % (1 << po) != 0
                          or (bs >> po) < max(order_guess, 1) + 1):
            po -= 1
        _encode_subframe(bw, x, ch_bps, force=force_subframe,
                         max_lpc_order=max_lpc_order, partition_order=po,
                         rice2=rice2, lpc_precision=lpc_precision,
                         allow_wasted=allow_wasted)

    bw.align()
    body = bw.getvalue()
    frame_wo_crc = bytes(header) + body
    return frame_wo_crc + struct.pack(">H", crc16(frame_wo_crc))


def synth_music(n, channels=2, bps=16, seed=0, sample_rate=44100):
    """Synthesize music-like audio: a few drifting harmonics + noise,
    correlated across channels (so mid/side coding helps, like real music)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / sample_rate
    base = np.zeros(n)
    for _ in range(6):
        f = rng.uniform(60, 2000)
        amp = rng.uniform(0.05, 0.3)
        vib = rng.uniform(0.5, 4.0)
        base += amp * np.sin(2 * np.pi * f * t + 0.3 * np.sin(2 * np.pi * vib * t))
    envelope = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 0.37 * t))
    base *= envelope
    out = np.zeros((n, channels))
    for c in range(channels):
        noise = rng.normal(0, 0.01, n)
        out[:, c] = base * rng.uniform(0.8, 1.0) + noise
    peak = np.abs(out).max()
    scale = (1 << (bps - 2)) / max(peak, 1e-9)
    return np.round(out * scale).astype(np.int64)
