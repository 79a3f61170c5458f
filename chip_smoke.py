#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (claxon_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

  (a) print the card's name and power limit (nvidia-smi) and build the
      CUDA kernels from ``claxon_tpu_torch/csrc``;
  (b) run each kernel (K1 synthesis, K2 stream Rice decode, K4 range
      CRC-16) on the card against its plain PyTorch form, on the bucket
      inputs the main path builds for the headline corpus and every
      bucket of the mixed corpus, plus K1 edge cases; equality is exact
      (tolerance 0: every value is an integer);
  (c) decode the headline corpus (8 x 10 s of 16-bit 44.1 kHz stereo,
      block size 4096, seeds 1000-1007, replicated x4 into one batch of
      32 streams), the mixed corpus (8 specs, seeds 2000-2007) and
      ``testsamples/generated/*.flac`` through the public calls with
      device="cuda", and hold every PCM to the C++ scalar decoder and the
      STREAMINFO MD5; the kernels' launch counts are reset just before the
      headline decode and read just after it;
  (d) corrupt one stored frame CRC byte: the decode must raise
      claxon_tpu.Error "frame CRC mismatch", which only K4 can detect;
  (e) time the device-resident and to-host decode of the headline batch.

The last two lines are the kernels' JSON summary and the result
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero and prints no result. It never imports JAX.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

HEADLINE_SEEDS = range(1000, 1008)
HEADLINE_SECONDS = 10
HEADLINE_REPLICAS = 4
MIXED_SPECS = [
    dict(block_size=1152, max_lpc_order=2, partition_order=1),
    dict(block_size=4096, max_lpc_order=12, partition_order=4),
    dict(block_size=4608, max_lpc_order=8, partition_order=3),
    dict(block_size=4096, stereo="left_side", partition_order=2),
    dict(block_size=4096, stereo="right_side", partition_order=2),
    dict(block_size=4096, rice2=True, partition_order=4),
    dict(block_size=2048, bps=24, max_lpc_order=8, partition_order=3),
    dict(block_size=4096, bps=16, force_subframe="fixed",
         partition_order=2),
]
TIMED_RUNS = 5
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def headline_corpus():
    from claxon_tpu.testing import encode_flac, synth_music

    return [encode_flac(synth_music(44100 * HEADLINE_SECONDS, channels=2,
                                    bps=16, seed=s), 44100, 16,
                        block_size=4096) for s in HEADLINE_SEEDS]


def mixed_corpus():
    from claxon_tpu.testing import encode_flac, synth_music

    datas = []
    for i, spec in enumerate(MIXED_SPECS):
        spec = dict(spec)
        bps = spec.pop("bps", 16)
        pcm = synth_music(44100 * 4, channels=2, bps=bps, seed=2000 + i)
        datas.append(encode_flac(pcm, 44100, bps, **spec))
    return datas


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel_fn, plain_fn, reps=20):
    """Run kernel and plain form on the card; exact equality or raise.
    Returns (max_abs_err, kernel_ms, plain_ms)."""
    import torch

    got = kernel_fn()                      # warm-up, and the compared run
    torch.cuda.synchronize()
    want = plain_fn()
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain (max abs err {err})")
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, 1)
    return err, ms, plain_ms


def phase_b(datas4, mixed):
    """Kernels against their plain forms on main-path bucket inputs."""
    import numpy as np
    import torch

    from claxon_tpu import native
    from claxon_tpu_torch.ops import crc, entropy, predict
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import (inputs_from_numpy,
                                                plan_raw_bits, unpack_mb)

    rows = {}
    for label, datas in (("headline", datas4), ("mixed", mixed)):
        bp = plan_raw_bits(extract_streams_bits(datas, native), 128)
        for bi, b in enumerate(bp.bits):
            stream, mb, se = inputs_from_numpy(bp.stream, b.mb, bp.se,
                                              DEVICE)
            u = unpack_mb(mb, b.n_parts_max, b.nc)
            k2_args = (stream, u["bases"], u["ks"], u["ps"], u["orders"],
                       u["pbits"], u["flags"], u["warm"], u["lengths"])
            kw = dict(n_parts_max=b.n_parts_max, sa=b.sa)
            shape = f"L={b.mb.shape[0]} T={b.nc * 32} P={b.n_parts_max} " \
                f"SA={b.sa}"
            r2 = compare(f"K2 {label}[{bi}] {shape}",
                         lambda: entropy.decode_residual_bits_stream(
                             *k2_args, **kw),
                         lambda: entropy.decode_residual_bits_stream_plain(
                             *k2_args, **kw))
            x = entropy.decode_residual_bits_stream(*k2_args, **kw)
            k1_args = (x, u["coefs"], u["shifts"], u["orders"],
                       u["lengths"])
            r1 = compare(f"K1 {label}[{bi}] {shape}",
                         lambda: predict.synthesize(*k1_args),
                         lambda: predict.synthesize_plain(*k1_args))
            log(f"(b) {label} bucket {bi} {shape}: K2 == plain "
                f"({r2[1]:.3f} ms vs {r2[2]:.1f} ms), K1 == plain "
                f"({r1[1]:.3f} ms vs {r1[2]:.1f} ms)")
            if label == "headline" and bi == 0:
                rows["K2"], rows["K1"] = r2, r1
                main_shape = shape
        # K4 on the batch's deferred frame ranges: the stored CRC is
        # included (all zero when intact) and excluded (the CRC itself,
        # which must equal the stored bytes and the host's crc16).
        starts, ends = se[0].contiguous(), se[1].contiguous()
        r4 = compare(f"K4 {label} F={starts.shape[0]}",
                     lambda: crc.crc16_ranges(stream, starts, ends),
                     lambda: crc.crc16_ranges_plain(stream, starts, ends))
        ends2 = torch.where(ends > starts, ends - 2, ends).contiguous()
        compare(f"K4 {label} (stored CRC excluded)",
                lambda: crc.crc16_ranges(stream, starts, ends2),
                lambda: crc.crc16_ranges_plain(stream, starts, ends2), 1)
        raw = bp.stream.astype(">i4").tobytes()
        got = crc.crc16_ranges(stream, starts, ends2).cpu().numpy()
        n = bp.n_crc
        s_np, e_np = bp.se[0][:n], bp.se[1][:n] - 2
        want = np.array([native.crc16_bytes(raw[a:b])
                         for a, b in zip(s_np, e_np)], np.int32)
        if not np.array_equal(got[:n], want):
            raise AssertionError(f"K4 {label}: != host crc16_bytes")
        if crc.crc16_ranges(stream, starts, ends)[:n].any():
            raise AssertionError(f"K4 {label}: an intact frame failed")
        log(f"(b) {label} K4 F={starts.shape[0]}: == plain == host crc16 "
            f"({r4[1]:.3f} ms vs {r4[2]:.1f} ms)")
        if label == "headline":
            rows["K4"] = r4
            k4_shape = f"F={starts.shape[0]}"

    # K1 edge cases: order 32, shift 15, |c| = 2^15 - 1, int32 wrap.
    rng = np.random.default_rng(3)
    L, T = 256, 4096
    x = rng.integers(-(1 << 31), 1 << 31, (L, T), dtype=np.int64) \
        .astype(np.int32)
    coefs = np.where(rng.integers(0, 2, (L, 32)) == 1, (1 << 15) - 1,
                     -((1 << 15) - 1)).astype(np.int32)
    orders = np.full(L, 32, np.int32)
    orders[::4] = rng.integers(0, 33, L // 4)
    shifts = np.full(L, 15, np.int32)
    shifts[1::4] = 0
    lengths = rng.integers(T // 2, T + 1, L).astype(np.int32)
    t = [torch.from_numpy(a).to(DEVICE) for a in
         (x, coefs, shifts, orders, lengths)]
    compare("K1 edge cases", lambda: predict.synthesize(*t),
            lambda: predict.synthesize_plain(*t), 1)
    log("(b) K1 edge cases (order 32, shift 15, |c| = 2^15-1, int32 wrap): "
        "kernel == plain")
    return rows, main_shape, k4_shape


def check_decoded(label, datas, results):
    """Every PCM equals the scalar decoder's, and its MD5 where stored."""
    import numpy as np

    from claxon_tpu import native
    from claxon_tpu.testing import pcm_md5

    if len(results) != len(datas):
        raise AssertionError(f"{label}: {len(results)} results for "
                             f"{len(datas)} streams")
    n_md5 = 0
    for i, (data, dec) in enumerate(zip(datas, results)):
        si, pcm = native.decode_stream_scalar(data)
        if not np.array_equal(dec.pcm, pcm):
            raise AssertionError(f"{label}[{i}]: PCM != scalar decoder")
        if si.md5sum != b"\x00" * 16:
            if pcm_md5(dec.pcm, si.bits_per_sample) != si.md5sum:
                raise AssertionError(f"{label}[{i}]: MD5 mismatch")
            n_md5 += 1
    log(f"(c) {label}: {len(datas)} streams bit-exact vs the scalar "
        f"decoder, {n_md5} MD5 matches")


def corrupt_first_frame_crc(data):
    """``data`` with the stored CRC-16 of its first frame flipped."""
    from claxon_tpu import native
    from claxon_tpu.native.binding import _read_metadata

    _si, bb = native.extract_stream_bits(data, emit_slots=False)
    _si, pos = _read_metadata(data)
    bad = bytearray(data)
    bad[pos + int(bb.bframes[0]["byte1"]) - 1] ^= 0xFF
    return bytes(bad)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs on a CUDA card", file=sys.stderr)
        return 2

    import numpy as np

    import claxon_tpu
    import claxon_tpu_torch as ct
    from claxon_tpu import native
    from claxon_tpu_torch.ops import _build, crc, entropy, predict
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import plan_raw_bits

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"(a) card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    _build.load()
    log(f"(a) kernels built and loaded in {_build.build_seconds:.1f} s")
    if not native.available():
        raise AssertionError("the C++ host core did not build")

    t0 = time.perf_counter()
    base = headline_corpus()
    datas4 = base * HEADLINE_REPLICAS
    mixed = mixed_corpus()
    generated = [p.read_bytes() for p in
                 sorted((REPO / "testsamples" / "generated").glob("*.flac"))]
    log(f"(a) corpora encoded in {time.perf_counter() - t0:.1f} s: "
        f"headline x{HEADLINE_REPLICAS} = {len(datas4)} streams "
        f"({sum(map(len, datas4))} bytes), mixed {len(mixed)}, generated "
        f"{len(generated)}")

    rows, main_shape, k4_shape = phase_b(datas4, mixed)

    # (c) the main path, through the public calls.
    wrappers = {"K1": predict.synthesize,
                "K2": entropy.decode_residual_bits_stream,
                "K4": crc.crc16_ranges}
    for w in wrappers.values():
        w.launches = 0
    res = ct.decode_streams(datas4, device=DEVICE)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"(c) launches in the headline decode: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched by the main path")
    check_decoded(f"headline x{HEADLINE_REPLICAS}", datas4, res)
    total_samples = sum(r.pcm.size for r in res)
    check_decoded("mixed", mixed, ct.decode_streams(mixed, device=DEVICE))
    check_decoded("generated", generated,
                  ct.decode_streams(generated, device=DEVICE))
    check_decoded("generated, one stream at a time", generated,
                  [ct.decode_stream(d, device=DEVICE) for d in generated])
    check_decoded(f"headline x{HEADLINE_REPLICAS}, pipelined in batches of 8", datas4,
                  ct.decode_streams_pipelined(datas4, batch_streams=8,
                                              device=DEVICE))
    dd = ct.decode_streams_device(datas4, device=DEVICE).sync()
    buckets = dd.device_buckets()
    if not all(b[2].device.type == torch.device(DEVICE).type
               and b[2].dtype == torch.int32 for b in buckets):
        raise AssertionError("device_buckets() are not int32 tensors on "
                             "the card")
    check_decoded(f"headline x{HEADLINE_REPLICAS}, device-resident", datas4, dd.to_host())

    # (d) a corrupted stored frame CRC is refused, by K4 alone.
    bad = corrupt_first_frame_crc(base[0])
    crc.crc16_ranges.launches = 0
    dd = ct.decode_streams_device([base[1], bad], device=DEVICE)
    try:
        dd.to_host()
    except claxon_tpu.Error as e:
        if "frame CRC mismatch" not in str(e):
            raise
        log(f"(d) corrupted frame refused: {e}")
    else:
        raise AssertionError("a corrupted frame CRC was not detected")
    try:
        dd.sync()
    except claxon_tpu.Error as e:
        if "frame CRC mismatch" not in str(e):
            raise
    else:
        raise AssertionError("the CRC failure did not latch")
    if crc.crc16_ranges.launches != 1:
        raise AssertionError("K4 did not run for the corrupted batch")
    log("(d) the failure latches (sync() raises again); K4 ran once")

    # (e) rates on the headline batch (samples = every channel's samples).
    def timed(fn):
        ts = []
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts), min(ts)

    timed(lambda: ct.decode_streams_device(datas4, device=DEVICE).sync())
    walk_s, _ = timed(lambda: extract_streams_bits(datas4, native))
    braws = extract_streams_bits(datas4, native)
    plan_s, _ = timed(lambda: plan_raw_bits(braws, 128))
    res_s, res_min = timed(
        lambda: ct.decode_streams_device(datas4, device=DEVICE).sync())
    host_s, host_min = timed(
        lambda: ct.decode_streams(datas4, device=DEVICE))
    scalar_s, _ = timed(lambda: [native.decode_stream_scalar(d)
                                 for d in datas4])
    ms = total_samples / 1e6
    log(f"(e) {card}: headline x{HEADLINE_REPLICAS}, {total_samples} "
        f"samples, median of {TIMED_RUNS}:")
    log(f"(e)   device-resident {ms / res_s:.2f} Ms/s "
        f"({res_s * 1e3:.1f} ms; best {ms / res_min:.2f} Ms/s)")
    log(f"(e)   to-host         {ms / host_s:.2f} Ms/s "
        f"({host_s * 1e3:.1f} ms; best {ms / host_min:.2f} Ms/s)")
    log(f"(e)   of which host walk {walk_s * 1e3:.1f} ms, planning "
        f"{plan_s * 1e3:.1f} ms; kernels on the main bucket "
        f"({main_shape}): K2 {rows['K2'][1]:.3f} ms, K1 "
        f"{rows['K1'][1]:.3f} ms, K4 ({k4_shape}) {rows['K4'][1]:.3f} ms")
    log(f"(e)   C++ scalar decode on the host: {ms / scalar_s:.2f} Ms/s")

    sources = {"K1": ("claxon_tpu_torch/csrc/synth.cu",
                      "claxon_tpu/ops/pallas_synth.py:127"),
               "K2": ("claxon_tpu_torch/csrc/entropy.cu",
                      "claxon_tpu/ops/entropy.py:158"),
               "K4": ("claxon_tpu_torch/csrc/crc.cu",
                      "claxon_tpu/ops/crc.py:193")}
    kernels = [{"name": k, "route": "cuda", "source": sources[k][0],
                "replaces": sources[k][1], "launches": launches[k],
                "max_abs_err": rows[k][0], "ms": rows[k][1],
                "plain_ms": rows[k][2]} for k in ("K1", "K2", "K4")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
