"""The benchmark's frozen FLAC encoder: a copy of the port's test encoder
(``claxon_tpu_torch/testing/flacgen.py``: ``synth_music`` and the frame
coder of ``encode_flac``), kept here so that a change to the port cannot
move the yardstick. Written from the FLAC format specification.

Beyond the copy it does what libFLAC's presets ask where that is cheap:
the exhaustive stereo choice (``-m``: left/right, left/side, side/right
and mid/side are all coded and the smallest pair is kept), the search of
every Rice partition order up to the preset's, RICE2 (5-bit parameters)
for a residual whose best parameter passes 14, and libFLAC's choice of
the LPC coefficient precision. It keeps the copy's fixed LPC order (the
preset's maximum) and its Hann window; the configuration files list these
under ``assumed``.

Only ``encode_frame`` and ``synth_music`` are used by the benchmark: a
frame is coded alone (its warm-up samples are verbatim), so a pool of
frames can be coded in parallel and reassembled into streams
(``assemble``).
"""

import struct

import numpy as np

from .crc import crc8, crc16

__all__ = ["encode_frame", "synth_music", "utf8_number", "lpc_precision",
           "BLOCK_SIZE_CODES", "SAMPLE_RATE_CODES", "BPS_CODES"]

BLOCK_SIZE_CODES = {192: 0b0001, 576: 0b0010, 1152: 0b0011, 2304: 0b0100,
                    4608: 0b0101, 256: 0b1000, 512: 0b1001, 1024: 0b1010,
                    2048: 0b1011, 4096: 0b1100, 8192: 0b1101, 16384: 0b1110,
                    32768: 0b1111}
SAMPLE_RATE_CODES = {88200: 0b0001, 176400: 0b0010, 192000: 0b0011,
                     8000: 0b0100, 16000: 0b0101, 22050: 0b0110,
                     24000: 0b0111, 32000: 0b1000, 44100: 0b1001,
                     48000: 0b1010, 96000: 0b1011}
BPS_CODES = {8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101, 24: 0b110}
#: channel assignment code of each stereo mode.
_STEREO_CODES = {"left_side": 0b1000, "right_side": 0b1001,
                 "mid_side": 0b1010}


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

    def bits(self):
        """(value, n_bits): everything written, as one integer."""
        return ((int.from_bytes(self._out, "big") << self._nbits)
                | self._acc, len(self._out) * 8 + self._nbits)


def utf8_number(value):
    """The frame number in the specification's UTF-8-like coding."""
    if not 0 <= value < (1 << 36):
        raise ValueError("frame/sample number exceeds 36 bits")
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


def lpc_precision(bps, block_size):
    """libFLAC's default quantized-coefficient precision
    (``stream_encoder.c``, ``qlp_coeff_precision == 0``)."""
    if bps < 16:
        return max(5, 2 + bps // 2)
    if bps == 16:
        for limit, prec in ((192, 7), (384, 8), (576, 9), (1152, 10),
                            (2304, 11), (4608, 12)):
            if block_size <= limit:
                return prec
        return 13
    if block_size <= 384:
        return 13
    if block_size <= 1152:
        return 14
    return 15


def _zigzag(v):
    return np.where(v >= 0, v * 2, -2 * v - 1)


def _fixed_residual(x, order):
    r = x
    for _ in range(order):
        r = r[1:] - r[:-1]
    return r


def _rice_cost(u, max_param):
    """(best parameter, bits) of one partition's zig-zagged residual."""
    if len(u) == 0:
        return 0, 0
    mean = max(1, int(u.mean()))
    p = max(0, min(max_param, mean.bit_length() - 1))
    best_p, best_cost = p, None
    for cand in range(max(0, p - 1), min(max_param, p + 2) + 1):
        cost = int((u >> cand).sum()) + len(u) * (cand + 1)
        if best_cost is None or cost < best_cost:
            best_p, best_cost = cand, cost
    return best_p, best_cost


def _plan_residual(resid, block_size, order, max_partition_order):
    """libFLAC's search: every partition order the block allows, up to
    ``max_partition_order``; each partition's best parameter (RICE2 when
    one passes 14). Returns (partition order, params, rice2)."""
    u = _zigzag(resid.astype(np.int64))
    best = None
    for po in range(max_partition_order + 1):
        if block_size % (1 << po) or (block_size >> po) <= order:
            break
        per = block_size >> po
        bounds = [0] + [per * (i + 1) - order for i in range(1 << po)]
        params, bits = [], 0
        for a, b in zip(bounds[:-1], bounds[1:]):
            p, c = _rice_cost(u[a:b], 30)
            params.append(p)
            bits += c
        rice2 = max(params) > 14
        bits += (5 if rice2 else 4) * len(params)
        if best is None or bits < best[0]:
            best = (bits, po, params, rice2)
    return best[1], best[2], best[3]


def _encode_residual(bw, resid, block_size, order, max_partition_order):
    po, params, rice2 = _plan_residual(resid, block_size, order,
                                       max_partition_order)
    bw.write(0b01 if rice2 else 0b00, 2)
    bw.write(po, 4)
    per = block_size >> po
    param_bits = 5 if rice2 else 4
    pos = 0
    for i, param in enumerate(params):
        length = per - order if i == 0 else per
        chunk = _zigzag(resid[pos:pos + length].astype(np.int64))
        pos += length
        bw.write(param, param_bits)
        for v in chunk.tolist():
            bw.write_unary(v >> param)
            bw.write(v, param)


def _quantize_lpc(coefs_float, precision):
    cmax = np.abs(coefs_float).max()
    if cmax <= 0:
        return None
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
    """Levinson-Durbin on the autocorrelation of the Hann-windowed
    signal; prediction x[t] ~ sum coefs[j] * x[t-1-j]."""
    n = len(x)
    if n <= order:
        return None
    xf = x.astype(np.float64) * np.hanning(n)
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
    return coefs


def _encode_subframe(samples, bps, max_lpc_order, max_partition_order,
                     precision, force=None):
    """One channel's subframe; returns (value, n_bits)."""
    bw = BitWriter()
    n = len(samples)
    x = samples.astype(np.int64)
    wasted = 0
    if np.any(x):
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
        elif max_lpc_order > 0 and n > max_lpc_order * 2:
            kind = "lpc"
        else:
            kind = "fixed"
    if kind == "constant":
        write_header(0)
        bw.write(int(x[0]), sf_bps)
        return bw.bits()
    if kind == "fixed":
        best_order, best_cost = 0, None
        for order in range(min(4, n - 1) + 1):
            cost = int(np.abs(_fixed_residual(x, order)).sum())
            if best_cost is None or cost < best_cost:
                best_order, best_cost = order, cost
        order = best_order
        write_header(0b001000 | order)
        for v in x[:order].tolist():
            bw.write(v, sf_bps)
        _encode_residual(bw, _fixed_residual(x, order), n, order,
                         max_partition_order)
        return bw.bits()
    order = min(max_lpc_order, 32, n - 1)
    cf = _lpc_coefficients(x, order)
    quant = None if cf is None else _quantize_lpc(cf, precision)
    if quant is None:
        return _encode_subframe(samples, bps, max_lpc_order,
                                max_partition_order, precision,
                                force="fixed")
    q, shift = quant
    pred = np.zeros(n - order, dtype=np.int64)
    for j in range(order):
        pred += q[j] * x[order - 1 - j:n - 1 - j]
    resid = x[order:] - (pred >> shift)
    write_header(0b100000 | (order - 1))
    for v in x[:order].tolist():
        bw.write(v, sf_bps)
    bw.write(precision - 1, 4)
    bw.write(shift, 5)
    for j in range(order):
        bw.write(int(q[j]), precision)
    _encode_residual(bw, resid, n, order, max_partition_order)
    return bw.bits()


def encode_frame(chunk, sample_rate, bps, number, max_lpc_order,
                 max_partition_order, precision=None):
    """One fixed-blocksize frame of ``chunk`` ((block_size, channels)
    int), numbered ``number``. Stereo takes the smallest of the four
    channel assignments. Returns the frame's bytes, CRC-16 included."""
    chunk = np.asarray(chunk, dtype=np.int64)
    bs, channels = chunk.shape
    if precision is None:
        precision = lpc_precision(bps, bs)

    def sub(x, b):
        return _encode_subframe(x, b, max_lpc_order, max_partition_order,
                                precision)

    if channels == 2:
        left, right = chunk[:, 0], chunk[:, 1]
        side = left - right
        cand = {"l": sub(left, bps), "r": sub(right, bps),
                "m": sub((left + right) >> 1, bps), "s": sub(side, bps + 1)}
        pairs = {1: "lr", _STEREO_CODES["left_side"]: "ls",
                 _STEREO_CODES["right_side"]: "sr",
                 _STEREO_CODES["mid_side"]: "ms"}
        ca_code, names = min(pairs.items(), key=lambda kv: sum(
            cand[c][1] for c in kv[1]))
        subframes = [cand[c] for c in names]
    else:
        ca_code = channels - 1
        subframes = [sub(chunk[:, c], bps) for c in range(channels)]

    header = bytearray(b"\xff\xf8")
    bs_code = BLOCK_SIZE_CODES.get(bs)
    bs_tail = b""
    if bs_code is None:
        if bs <= 256:
            bs_code, bs_tail = 0b0110, bytes([bs - 1])
        else:
            bs_code, bs_tail = 0b0111, struct.pack(">H", bs - 1)
    sr_code = SAMPLE_RATE_CODES.get(sample_rate)
    if sr_code is None:
        raise ValueError(f"sample rate {sample_rate} has no header code")
    header.append((bs_code << 4) | sr_code)
    header.append((ca_code << 4) | (BPS_CODES[bps] << 1))
    header += utf8_number(number)
    header += bs_tail
    header.append(crc8(header))

    value, n_bits = 0, 0
    for v, nb in subframes:
        value = (value << nb) | v
        n_bits += nb
    pad = -n_bits % 8
    body = (value << pad).to_bytes((n_bits + pad) // 8, "big")
    frame = bytes(header) + body
    return frame + struct.pack(">H", crc16(frame))


def synth_music(n, channels=2, bps=16, seed=0, sample_rate=44100):
    """Music-like audio: a few drifting harmonics and noise, correlated
    across channels (so mid/side coding helps, like real music)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / sample_rate
    base = np.zeros(n)
    for _ in range(6):
        f = rng.uniform(60, 2000)
        amp = rng.uniform(0.05, 0.3)
        vib = rng.uniform(0.5, 4.0)
        base += amp * np.sin(2 * np.pi * f * t
                             + 0.3 * np.sin(2 * np.pi * vib * t))
    envelope = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 0.37 * t))
    base *= envelope
    out = np.zeros((n, channels))
    for c in range(channels):
        noise = rng.normal(0, 0.01, n)
        out[:, c] = base * rng.uniform(0.8, 1.0) + noise
    peak = np.abs(out).max()
    scale = (1 << (bps - 2)) / max(peak, 1e-9)
    return np.round(out * scale).astype(np.int64)
