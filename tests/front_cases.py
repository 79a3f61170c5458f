"""Inputs of the fused demux front (claxon_tpu_torch.ops.seg_parse.
demux_front) for its CPU tests (the numpy model of the kernel against the
plain form, tests/test_torch_segment.py) and its card tests
(tests/test_torch_cuda.py): real frame groups, header copies around tile
boundaries, dense sync runs and tiny uploads. Imports no JAX."""

import numpy as np

from claxon_tpu.native.binding import _read_metadata
from claxon_tpu.testing import encode_flac, synth_music


#: bytes of one tile of the front's kernels (256 threads of 16 words).
TILE_BYTES = 4 * 4096


def payload(data):
    """A stream's frame section."""
    return data[_read_metadata(data)[1]:]


def saturated(n, seed):
    """n bytes of 0xFF and 0xF8, half each: a sync hit at every FF F8."""
    rng = np.random.default_rng(seed)
    return bytes(np.where(rng.random(n) < 0.5, 0xFF, 0xF8)
                 .astype(np.uint8))


def real_group():
    """Three word-padded streams as one group upload (begin_segmented's
    layout), with their ends and bits per sample."""
    datas = [encode_flac(synth_music(2600, channels=2, bps=16, seed=31 + i),
                         44100, 16, block_size=bs) for i, bs in
             enumerate((576, 1024, 192))]
    payloads = [payload(d) for d in datas]
    buf, ends = b"", []
    for p in payloads:
        buf += p
        ends.append(len(buf))
        buf += b"\0" * (-len(buf) % 4)
    return buf, ends, payloads


def mimic_stream(tile_bytes, n_tiles, header, seed):
    """Noise with a copy of a real frame header at an offset of -20 to
    +20 bytes (a different one at each) from every tile boundary, and a
    bare sync pair (FF F8 or FF F9) just after each copy."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 255, tile_bytes * n_tiles + 137, dtype=np.uint8)
    buf[buf == 255] = 0  # no accidental hits
    for b in range(1, n_tiles + 1):
        d = (b * 7) % 41 - 20
        at = b * tile_bytes + d
        if at + len(header) <= len(buf):
            buf[at:at + len(header)] = np.frombuffer(header, np.uint8)
        at = b * tile_bytes + d + 18
        if at + 2 <= len(buf):
            buf[at:at + 2] = (0xFF, 0xF9 if b % 2 else 0xF8)
    return buf.tobytes()


def le_words(buf):
    buf = bytes(buf) + b"\0" * (-len(buf) % 4)
    return np.frombuffer(buf, "<i4").astype(np.int32)


def front_case(case):
    """(words_le, n_bytes, ends, si_bps, T, nch, C, wcap) of each case."""
    buf, ends, payloads = real_group()
    header = payloads[0][:16]  # the first frame's header (and a bit more)
    sixteen = np.array([16] * 8, np.int32)
    pad = lambda e, n: np.array(list(e) + [n] * (8 - len(e)), np.int32)
    if case.startswith("real"):
        C, wcap = {"real": (64, 256), "real_cut_c": (5, 256),
                   "real_cut_wcap": (64, 3)}[case]
        return le_words(buf), len(buf), pad(ends, len(buf)), sixteen, \
            1024, 2, C, wcap
    if case.startswith("mimics"):
        tile_bytes = 64 if case == "mimics_small_tiles" else TILE_BYTES
        n = 40 if case == "mimics_small_tiles" else 3
        raw = mimic_stream(tile_bytes, n, header, 5)
        return le_words(raw), len(raw), pad([len(raw) // 2], len(raw)), \
            sixteen, 4096, 2, 256, 256
    if case.startswith("dense"):
        rng = np.random.default_rng(6)
        raw = bytearray(rng.integers(0, 200, 3 * TILE_BYTES + 300,
                                     dtype=np.uint8).tobytes())
        lo, hi = TILE_BYTES - 3000, TILE_BYTES + 9000  # across a boundary
        raw[lo:hi] = saturated(hi - lo, 7)
        raw[200:216] = header
        if case == "dense_many_streams":
            # More streams than the kernels keep in shared memory (256):
            # the header decode reads the ends and bits per sample from
            # device memory.
            ends = np.sort(rng.integers(0, len(raw), 264)).astype(np.int32)
            ends[-1] = len(raw)
            return le_words(raw), len(raw), ends, \
                rng.choice([0, 4, 8, 12, 16, 20, 24, 32], 264) \
                .astype(np.int32), 4096, 2, 4096, 512
        C = 1000 if case == "dense" else 20
        return le_words(raw), len(raw) - 1, pad([], len(raw)), sixteen, \
            4096, 2, C, 64
    W, n_bytes = {"w1_n0": (1, 0), "w1_n1": (1, 1), "w1_n2": (1, 2),
                  "w1_n4": (1, 4), "w2_n7": (2, 7), "w3_n12": (3, 12),
                  "w3_n9": (3, 9), "w0": (0, 0), "w0_n5": (0, 5)}[case]
    raw = b"\xff\xf8\xff\xf9\x00\xff\xf8\xc9\xff\xf8\x00\xff"[:4 * W]
    return le_words(raw), n_bytes, pad([], 4 * W), sixteen, 256, 2, 8, 4


FRONT_CASES = ["real", "real_cut_c", "real_cut_wcap", "mimics_small_tiles",
                "mimics", "dense", "dense_cut_mid_tile", "dense_many_streams",
                "w1_n0", "w1_n1",
                "w1_n2", "w1_n4", "w2_n7", "w3_n12", "w3_n9", "w0", "w0_n5"]
