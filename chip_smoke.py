#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (claxon_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

  (a) print the card's name and power limit (nvidia-smi) and build the
      CUDA kernels from ``claxon_tpu_torch/csrc`` (one nvcc per source,
      in parallel);
  (b) run each kernel on the card against its plain PyTorch form, with
      exact equality (tolerance 0: every value is an integer): K1
      synthesis, K2 stream Rice decode and K4 range CRC-16 on the bucket
      inputs the host-walk path builds for the headline corpus and every
      bucket of the mixed corpus, plus K1 edge cases and the cases of its
      tap classes (a warp mixing orders 0, 1, 4, 8, 12 and 32;
      coefficients only in column 0; T from 1 to 4608 with 100 lanes and
      lengths below T); K3b int16 pack and unpack on the decoded output
      of the headline bucket and of every mixed bucket that packs, plus
      their edge cases (the int16 boundaries, int32 extremes, one
      out-of-range value in the last column of the last lane, per-lane
      flags, T = 2, pack -> unpack); K1 + K3 fused against its plain form
      and against K1 followed by K3's torch ops on every bucket, and timed
      against them at the headline bucket; K3 alone (torch ops, held to
      its CPU result) and the mb unpack timed alone there; K1 + K3 on the
      fallback-frame buckets of a corpus whose frames the device decoder
      cannot take (an int16 and an int32 upload); K4 against its plain
      form, the host's crc16 and, when build/k4_parent/crc.cu holds the
      parent's source, the parent kernel (timed parent, new, new, parent)
      on the headline and mixed ranges and on edge inputs (one range over
      the whole upload, 100,000 ranges of 0-3 bytes at every byte
      offset, ranges straddling every step and item boundary, clamped
      garbage), with the ptxas report of crc.cu and synth.cu; K2, with
      the ptxas report of entropy.cu, on every headline, mixed and
      generated bucket and, when build/k2_parent/entropy.cu holds the
      parent's source, beside the parent kernel (timed parent, new, new,
      parent) at each headline and mixed bucket; then the fused front
      (K6 bswap, K5 sync scan and header check, K6 fields and compaction
      in two kernels and one pass over the upload, with the ptxas report
      of seg_parse.cu), timed
      against the parent's seven operations in the same call (parent,
      new, new, parent), those pieces themselves (K6 bswap, K5, K6
      fields and compaction), K6's summary, K7 subframe walk and K8
      values gather on every group the segmented path builds for the
      headline and mixed corpora, and on every K8 dispatch of those
      decodes (K1 + K3 there too), and K4 on the segmented groups' ranges
      (beside its parent); the fused front also on every group of the
      segmented decodes of the fallback corpus, of one headline stream
      whose capacity classes are forced to 8 (the demux regrows), and of
      the generated and mixed corpora in (c);
      at each of those groups K7's time beside its parent kernel's (when
      build/k7_parent/demux.cu holds the parent's source), its bound and
      cycles per step, with the ptxas report of both sources, and on the
      mixed groups K7 writing its deltas against the plain walk (the
      values-only K7 equal to it), timed at the headline group; then the
      entropy routes' kernels, with the ptxas report of entropy_delta.cu
      and of its parent, entropy_delta_parent.cu: K9 on every bucket the
      delta planner builds for the headline and mixed corpora, K10 and K2
      on every dispatch of their segmented delta and scan decodes, each
      timed with its byte bound, K9 and K10 also against their parent
      kernels (equal outputs; timed parent, new, new, parent); then the three
      device functions that no decode route calls, with the ptxas report
      of rice.cu and crc_lanes.cu and of their parents, rice_parent.cu
      and crc_lanes_parent.cu: rice_decode, crc16_device and
      crc16_frames_device against their plain forms on the CPU tests'
      garbage and edge cases (rice_decode and crc16_frames_device also
      against their parent kernels) and at the headline x4 shapes
      (rice_decode over the main bucket's L x P partitions of T / P codes,
      held to the values that made its buffer too; crc16_device on the
      (F, B) byte matrix of the headline frames and crc16_frames_device on
      the headline upload with the host walk's ranges, every frame 0 and
      equal to K4), each timed with its byte bound, rice_decode and
      crc16_frames_device beside their parents (equal outputs; timed
      parent, new, new, parent; rice_decode's first 32 lanes alone too);
      every decode run below must launch them 0 times;
  (c) the default route: with CLAXON_TPU_SEGMENTATION unset and the
      cached choice reset, decode_streams_device(datas) calibrates
      ("auto") on the mixed corpus, then on headline x4, printing the
      chosen path, both paths' min times and the bit-exact check; then
      decode_streams_pipelined (batches of 8) through the default route
      and the segmented path, with its launch counts (K5-K8), bit-exact,
      and timed at depth 2 and 6 (runs 2, 6, 6, 2). Then
      decode the headline corpus (8 x 10 s of 16-bit 44.1 kHz stereo,
      block size 4096, seeds 1000-1007, replicated x4 into one batch of
      32 streams), the mixed corpus (8 specs, seeds 2000-2007) and
      ``testsamples/generated/*.flac`` through the public calls with
      device="cuda", on the host-walk path (segmentation="host", pinned
      in every call that counts or times it) and on the segmented path
      (segmentation="device"), and hold every PCM to the C++ scalar
      decoder and the STREAMINFO MD5; the PCM comes to the host through
      the int16 transfer (K3b pack at fetch time; the buckets that packed
      and the bytes copied back are printed, 56,623,104 for the headline
      bucket), and a damaged 16-bit stream whose garbage leaves int16
      (its frame CRC repaired) must set the overflow flag and come back
      through the int32 refetch with the scalar decoder's PCM; each
      path's kernel launch counts are reset just before its headline
      decode and read just after it (K1 alone and K3's torch ops must not
      run on the card); the fallback corpus decodes through K1 + K3
      alone; sync(), device_buckets() and
      lane_plans() must launch no K3b kernel; the segmented headline
      decode must not fall back, and the mixed 24-bit and generated
      6-channel streams must; on every default-route run K9 and K10
      launch 0 times and K7 writes no deltas, and on every run the
      parent front's wrappers (K6 bswap, K5, K6 fields) launch 0 times. Then the JAX package's
      other entropy routes, each variable set only around its calls:
      CLAXON_TPU_ENTROPY=delta (K9, no K2 or K4), CLAXON_TPU_SEG_ENTROPY=
      delta (K7 with deltas, K10, no K8) and =scan (K2 on the walk's
      bases, no K8) decode headline x4 (launches counted), mixed and
      generated to host bit-exactly, and each is timed device-resident
      (median of 3);
  (d) corrupt one stored frame CRC byte: the decode must raise
      claxon_tpu_torch.Error "frame CRC mismatch", which only K4 can
      detect, on both paths; with CLAXON_TPU_HOST_CRC=1, and in delta
      mode, it must raise from decode_streams_device itself, K4 never
      running;
  (e) time the device-resident and to-host decode of the headline batch
      on both paths, with the segmented path's host stages; split the
      to-host tail into the pack-and-copy wait and the host scatter (the
      program's claxon.fetch.* spans), with the int16 transfer and with
      it switched off;
  (f) decode one stream of at least 2^27 bytes (8 channels of 24-bit
      audio, FIXED subframes) on both paths: it walks in chunks of frames
      below the int32 limit, bit-exact against the scalar decoder and the
      STREAMINFO MD5; K4 against its plain form (and parent) on the
      frame ranges of each run, K2 on each bucket of each run (and its
      parent); the fused front against its plain form on the stream's
      whole upload, and K7 on its distinct frames, each as one 8-channel
      group;
  (g) mux each of the 8 headline streams, and the mixed 24-bit stream
      (whose bucket must not pack), into Ogg and into MP4 (3 frames per
      chunk) and decode them with decode_ogg_stream / decode_mp4_stream
      on the card: PCM equal to the scalar decoder's and the MD5; one
      corrupted Ogg page CRC and one short MP4 chunk must raise the
      reference's errors; the 24-bit stream and the first headline one,
      from Ogg and from MP4, with use_native=False (the Python extractor
      and the FrameDesc route) must give the default route's PCM;
  (h) the FrameDesc route: (h1) decode_streams(mixed + generated, False)
      through the Python extractor, bit-exact, launching K1 + K3 once a
      bucket and K3b unpack and pack exactly where the packing rule says
      (residuals that fit int16 with T even; frames of 16 bits or fewer),
      and none of K2, K4, K5-K10, K1 alone or K3's torch ops; (h2)
      headline x4 through decode_batches_device on the C++ extractor's
      FrameDescs: one bucket (6912, 4096), one launch each of K3b unpack,
      K1 + K3 and K3b pack, bit-exact, K1 + K3 held to its plain form on
      the bucket and timed with its bound, the extraction, the dispatch
      device-resident and to host timed (median of 5, with the range),
      and the bytes uploaded; (h3) decode_streams(headline[:2], True,
      device_decode_bucket), PCM equal to (h2)'s; (h4) FlacReader on the
      generated corpus on both reader routes (the native single-frame
      decode, and CLAXON_TPU_NO_NATIVE_READER=1), the samples' MD5 equal
      to STREAMINFO's;
  (i) the sharded route (claxon_tpu_torch.parallel): make_mesh() (one
      card) and a mesh of two shards on the one card each decode headline
      x4 through decode_streams_sharded on the host walk and the
      segmented path (each per-lane kernel launched once a shard per
      bucket or dispatch, the front, K7 and the summary once a group),
      then mixed and generated with segmentation "host", "device" and
      None ("auto", the cached choice reset), and mixed with
      use_native=False, every PCM equal to the unsharded decode's, the
      scalar decoder's and the MD5; the two-shard mesh also decodes
      headline x4 and mixed on the other entropy routes
      (CLAXON_TPU_ENTROPY=delta: K9; CLAXON_TPU_SEG_ENTROPY=delta: K10;
      =scan: K2), each per-lane kernel launched twice where (c)'s
      unsharded decode of the route launched it once; K2 and K1 + K3 on
      each shard of the
      headline bucket, and K4 on each shard's half of its CRC ranges,
      against their plain forms and timed; the overflow
      stream through two shards (its shard's per-lane flag fires, that
      shard alone comes back as int32); the device-resident decode of
      headline x4 on both meshes, both paths, timed in turns (median of
      5, with the range);
  (j) the sample-shipping route, CLAXON_TPU_NO_BITS=1 set only around
      it: (j1) headline x4 through decode_streams_device (the cached
      "auto" choice ignored and left as it was) is one raw bucket (6912,
      4096) uploaded as int16 pairs, launching K3b unpack, K1 + K3 and K3b
      pack once each per batch to host and none of K2, K4, K5-K10; K3b
      unpack and K1 + K3 held to their plain forms on its recorded upload
      and timed with their bounds; the C++ raw extraction and the
      dispatch, device-resident and to host, timed (median of 5, with the
      range); (j2) mixed + generated through decode_streams, each
      kernel's launches as the FrameDesc route's packing rule predicts;
      (j3) the first headline stream from Ogg and from MP4 (the C++
      FrameDescs, then K3b unpack, K1 + K3 and K3b pack); (j4) headline
      x4 through decode_streams_sharded over two shards of the card (the
      FrameDesc step: K1 + K3 and K3b unpack once a shard, no K3b pack)
      and through the raw route over the same mesh; every PCM equal to
      the scalar decoder's and the MD5.

The last three lines are the kernels' JSON summary (time, plain time,
bound and launches of each on each path, K9 and K10 on their routes and
beside their parent kernels, K2 also on the scan route; the routes'
device-resident times; K1 + K3 also on (h2)'s bucket, and each kernel's
launches there, "launches_framedesc", with (h)'s numbers under
"framedesc"; the two-shard headline decodes' launches,
"launches_sharded" and "launches_sharded_segmented", and on the other
entropy routes "launches_sharded_routes", with (i)'s numbers under
"sharded"; (j)'s launches and numbers under "sample_shipping"; K1
alone, an entry point that no decode path
runs, under "off_path_kernels"; K3 and
the mb unpack, which are torch ops, under "torch_ops", K3 with its calls
on the card), the card's name and power limit, and the
result ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result. It imports neither JAX nor
the JAX package: the encoder, the C++ core and the errors are the
port's own.
"""

import functools
import json
import os
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
#: the 24-bit stream of the mixed corpus: its codes pass the subframe
#: walk's 32-bit cap, so it leaves the segmented path (as in the JAX
#: package) and takes the host walk.
MIXED_24BIT = dict(block_size=2048, bps=24, max_lpc_order=8,
                   partition_order=3)
MIXED_SPECS = [
    dict(block_size=1152, max_lpc_order=2, partition_order=1),
    dict(block_size=4096, max_lpc_order=12, partition_order=4),
    dict(block_size=4608, max_lpc_order=8, partition_order=3),
    dict(block_size=4096, stereo="left_side", partition_order=2),
    dict(block_size=4096, stereo="right_side", partition_order=2),
    dict(block_size=4096, rice2=True, partition_order=4),
    MIXED_24BIT,
    dict(block_size=4096, bps=16, force_subframe="fixed",
         partition_order=2),
]
TIMED_RUNS = 5
#: every phase runs on the card.
DEVICE = "cuda"
#: phase (f): one stream of at least this many bytes (the port's
#: MAX_BATCH_BYTES), 8 channels of 24-bit 96 kHz audio in FIXED subframes
#: with rice2 codes, block size 4096: about 2.5 bytes per sample, so about
#: 70 s of audio.
LARGE_MIN_BYTES = 1 << 27
LARGE_SOURCE_FRAMES = 31  # distinct frames, repeated with new numbers
#: bound rates of one H100 SXM (NVIDIA's data sheet): device memory, and
#: the scalar float32
#: rate outside the tensor cores, the closest figure the table has for
#: the kernels' integer multiply-adds.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: K7's parent design, timed beside the new one on the same inputs when its
#: source is here (a build directory, never committed): made with
#: ``mkdir -p build/k7_parent && git show <parent commit>:claxon_tpu_torch/
#: csrc/demux.cu > build/k7_parent/demux.cu``.
K7_PARENT_SRC = REPO / "build" / "k7_parent" / "demux.cu"
#: K4's parent design (one thread per range), the same way: ``mkdir -p
#: build/k4_parent && git show <parent commit>:claxon_tpu_torch/csrc/
#: crc.cu > build/k4_parent/crc.cu``.
K4_PARENT_SRC = REPO / "build" / "k4_parent" / "crc.cu"
#: K2's parent kernel source, built beside the new one when present:
#: ``mkdir -p build/k2_parent && git show <parent commit>:claxon_tpu_torch/
#: csrc/entropy.cu > build/k2_parent/entropy.cu``.
K2_PARENT_SRC = REPO / "build" / "k2_parent" / "entropy.cu"


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
    from claxon_tpu_torch.testing import encode_flac, synth_music

    return [encode_flac(synth_music(44100 * HEADLINE_SECONDS, channels=2,
                                    bps=16, seed=s), 44100, 16,
                        block_size=4096) for s in HEADLINE_SEEDS]


def mixed_corpus():
    from claxon_tpu_torch.testing import encode_flac, synth_music

    datas = []
    for i, spec in enumerate(MIXED_SPECS):
        spec = dict(spec)
        bps = spec.pop("bps", 16)
        pcm = synth_music(44100 * 4, channels=2, bps=bps, seed=2000 + i)
        datas.append(encode_flac(pcm, 44100, bps, **spec))
    return datas


def fallback_corpus():
    """Two streams whose frames the device decoder cannot take
    (partition order 7: more than its 64 partitions), so the host walk
    decodes their residuals and the planner puts them in fallback-frame
    buckets: 16-bit (uploaded as int16 pairs) and 24-bit (as int32)."""
    from claxon_tpu_torch.testing import encode_flac, synth_music

    return [encode_flac(synth_music(16384 * 3, channels=2, bps=bps,
                                    seed=5000 + bps), 44100, bps,
                        block_size=16384, max_lpc_order=4,
                        partition_order=7) for bps in (16, 24)]


def cuda_ms(fn, reps, queued=True):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events.

    Queued (the default, for kernels: ``fn`` must not wait for the card),
    the runs are enqueued behind a sleep kernel that outlasts the
    enqueueing, so the card runs them back to back and the time is the
    card's, not the host's per-call time (Python, ctypes, allocations),
    which paces a short kernel launched in a loop. Not queued, the host
    paces the runs as a caller's loop would."""
    import torch

    cycles = 1 << 24  # about 8.5 ms at 1.98 GHz
    while True:
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        if queued:
            ev[0].record()
            torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if not queued or ev[0].elapsed_time(ev[1]) > host_ms:
            return ev[1].elapsed_time(ev[2]) / reps
        if cycles >= 1 << 31:
            raise AssertionError("the host could not enqueue the runs "
                                 "ahead of the card")
        cycles *= 4


def tensor_bytes(*xs):
    """Bytes of every tensor in ``xs`` (tensors, or tuples, lists or dicts
    of them)."""
    import torch

    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, dict):
            n += tensor_bytes(*x.values())
        elif isinstance(x, (tuple, list)):
            n += tensor_bytes(*x)
    return n


def bound(nbytes, ops=0):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` once or do ``ops`` integer operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synth_ops(orders, lengths):
    """Multiply-adds (counted as 2 operations) that K1's inputs need: each
    lane's order taps at every predicted step."""
    import torch

    o = orders.to(torch.int64).clamp(0, 32)
    steps = (lengths.to(torch.int64) - o).clamp(min=0)
    return int((2 * o * steps).sum())


def flat_tensors(x):
    """The tensors of ``x`` (a tensor, or a tuple, list or dict of them;
    dicts in key order), flattened."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in flat_tensors(x[k])]
    return [t for v in x for t in flat_tensors(v)]


def compare(name, kernel_fn, plain_fn, reps=20):
    """Run kernel and plain form on the card; exact equality of every
    tensor they return (one, or a tuple or dict of them), or raise.
    Returns (max_abs_err, kernel_ms, plain_ms)."""
    import torch

    got = flat_tensors(kernel_fn())
    torch.cuda.synchronize()
    want = flat_tensors(plain_fn())
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: kernel and plain shapes differ")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    if len(got) != len(want) or err:
        raise AssertionError(f"{name}: kernel != plain (max abs err {err})")
    return err, cuda_ms(kernel_fn, reps), cuda_ms(plain_fn, 1, queued=False)


def compare_fused(tag, args, separate):
    """The fused K1 + K3 kernel on ``args`` against its plain form and
    against ``separate``, K1's kernel followed by K3's torch ops on the
    card; returns compare()'s result."""
    import torch

    from claxon_tpu_torch.ops import predict

    r = compare(f"K1+K3 {tag}", lambda: predict.synthesize_epilogue(*args),
                lambda: predict.synthesize_epilogue_plain(*args))
    if not torch.equal(predict.synthesize_epilogue(*args), separate):
        raise AssertionError(f"K1+K3 {tag}: != K1 then K3's torch ops")
    return r


def k4_report(tag, stream, starts, ends, r4, parent):
    """K4 on one set of ranges: its time beside the parent kernel's on the
    same inputs (outputs equal), in the order parent, new, new, parent,
    and its byte bound. Returns a dict of the numbers."""
    import torch

    from claxon_tpu_torch.ops import crc

    def new():
        return crc.crc16_ranges(stream, starts, ends)

    nb = bound(tensor_bytes(stream, starts, ends, starts))
    rep = {"ms": r4[1], "plain_ms": r4[2], "bound_ms": nb[0],
           "parent_ms": None}
    old_s = "not built (no parent source)"
    if parent is not None:
        if not torch.equal(parent(stream, starts, ends), new()):
            raise AssertionError(f"K4 {tag}: parent != new kernel")
        runs = [cuda_ms(lambda: parent(stream, starts, ends), 10),
                cuda_ms(new, 20), cuda_ms(new, 20),
                cuda_ms(lambda: parent(stream, starts, ends), 10)]
        rep.update(parent_ms=(runs[0] + runs[3]) / 2,
                   ms=(runs[1] + runs[2]) / 2, runs=runs)
        old_s = (f"{rep['parent_ms']:.4f} ms (runs parent, new, new, "
                 f"parent: {', '.join(f'{t:.4f}' for t in runs)}), outputs "
                 "equal")
    log(f"(b) K4 {tag}: new {rep['ms']:.4f} ms; parent {old_s}; bound "
        f"{nb[0]:.4f} ms ({nb[1]})")
    return rep


def k2_report(tag, args, kw, r2, parent):
    """K2 on one bucket's inputs: its time beside the parent kernel's on
    the same inputs (outputs equal), in the order parent, new, new,
    parent, and its byte bound. Returns a dict of the numbers."""
    import torch

    from claxon_tpu_torch.ops import entropy

    def new():
        return entropy.decode_residual_bits_stream(*args, **kw)

    nb = bound(tensor_bytes(args, new()))
    rep = {"ms": r2[1], "plain_ms": r2[2], "bound_ms": nb[0],
           "parent_ms": None}
    old_s = "not built (no parent source)"
    if parent is not None:
        if not torch.equal(parent(*args, **kw), new()):
            raise AssertionError(f"K2 {tag}: parent != new kernel")
        runs = [cuda_ms(lambda: parent(*args, **kw), 10),
                cuda_ms(new, 20), cuda_ms(new, 20),
                cuda_ms(lambda: parent(*args, **kw), 10)]
        rep.update(parent_ms=(runs[0] + runs[3]) / 2,
                   ms=(runs[1] + runs[2]) / 2, runs=runs)
        old_s = (f"{rep['parent_ms']:.4f} ms (runs parent, new, new, "
                 f"parent: {', '.join(f'{t:.4f}' for t in runs)}), outputs "
                 "equal")
    log(f"(b) K2 {tag}: new {rep['ms']:.4f} ms; parent {old_s}; bound "
        f"{nb[0]:.4f} ms ({nb[1]})")
    return dict(rep, bucket=tag)


def phase_b_crc(stream, parent):
    """K4's edge inputs on the headline upload ``stream`` (W words): one
    range over the whole upload (held to the host's crc16, which is exact,
    since the plain form steps one byte at a time), 100,000 ranges of 0-3
    bytes at every byte offset, ranges straddling every 512-byte step and
    4096-byte item boundary and of lengths around those sizes, and
    clamped garbage (held to the plain form); every case also to the
    parent kernel when it is built."""
    import numpy as np
    import torch

    from claxon_tpu_torch import native
    from claxon_tpu_torch.ops import crc

    rng = np.random.default_rng(41)
    nb = 4 * stream.shape[0]
    raw = stream.cpu().numpy().astype(">i4").tobytes()
    b = np.repeat(np.arange(512, 1 << 20, 512), 2)
    sizes = np.array([1, 511, 512, 513, 4095, 4096, 4097, 8191, 8192, 8193])
    at = rng.integers(0, nb - 9000, 4 * sizes.size)
    near = np.concatenate([rng.integers(-5000, 5000, 500),
                           rng.integers(nb - 5000, nb + 5000, 500)])
    tiny = np.arange(100000)
    cases = {
        "one range over the whole upload, and two inside it": (
            [0, 1, 3], [nb, nb - 1, nb - 5]),
        "100,000 ranges of 0-3 bytes at every byte offset": (
            tiny, tiny + tiny % 4),
        "ranges straddling every step and item boundary": (
            np.concatenate([b - rng.integers(1, 600, b.size),
                            at - at % 4 + np.arange(at.size) % 4]),
            np.concatenate([b + rng.integers(1, 4700, b.size),
                            at - at % 4 + np.arange(at.size) % 4
                            + np.tile(sizes, 4)])),
        "clamped garbage": (near, near + rng.integers(-100, 8000,
                                                       near.size)),
    }
    for label, (s, e) in cases.items():
        st = torch.from_numpy(np.asarray(s, np.int32)).to(DEVICE)
        en = torch.from_numpy(np.asarray(e, np.int32)).to(DEVICE)
        got = crc.crc16_ranges(stream, st, en)
        if label.startswith("one range"):
            want = [native.crc16_bytes(raw[a:b_]) for a, b_ in zip(s, e)]
            if got.tolist() != want:
                raise AssertionError(f"K4 {label}: != host crc16")
            ref = "the host's crc16"
        else:
            compare(f"K4 {label}", lambda: crc.crc16_ranges(stream, st, en),
                    lambda: crc.crc16_ranges_plain(stream, st, en), 1)
            ref = "the plain form"
        if parent is not None:
            if not torch.equal(parent(stream, st, en), got):
                raise AssertionError(f"K4 {label}: parent != new kernel")
            ref += " and the parent kernel"
        log(f"(b) K4 {label} (F={st.shape[0]}, W={stream.shape[0]}): == "
            f"{ref}")


def phase_b(datas4, mixed, generated):
    """Kernels against their plain forms on main-path bucket inputs; K2
    also on every bucket of the generated corpus."""
    import numpy as np
    import torch

    from claxon_tpu_torch import native, pipeline_bits
    from claxon_tpu_torch.ops import crc, entropy, epilogue, predict
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import (inputs_from_numpy,
                                                plan_raw_bits, unpack_mb)

    def lib_unpack(w):
        return w.view(torch.int16).to(torch.int32)

    def lib_pack_words(o):
        return o.to(torch.int16).view(torch.int32)

    rows, bounds, library = {}, {}, {}
    parent = k4_parent_crc()
    k2_parent = k2_parent_entropy()
    log("(b) K2 " + ptxas_report(REPO / "claxon_tpu_torch" / "csrc" /
                                 "entropy.cu"))
    log("(b) K4 " + ptxas_report(REPO / "claxon_tpu_torch" / "csrc" /
                                 "crc.cu"))
    log("(b) K1, K1+K3 " + ptxas_report(REPO / "claxon_tpu_torch" / "csrc" /
                                        "synth.cu"))
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
            rows.setdefault("K2_buckets", []).append(k2_report(
                f"{label}[{bi}] {shape}", k2_args, kw, r2, k2_parent))
            # K1 + K3 fused against K1 then K3's torch ops, then K3b on
            # its output: the bucket as start_fetch() packs it, and the
            # packed words unpacked (a fallback bucket's upload at this
            # bucket's size).
            y = predict.synthesize(*k1_args)
            k3_args = (y, u["wasted"], u["pair_modes"])
            k13_args = k1_args + k3_args[1:]
            r13 = compare_fused(f"{label}[{bi}] {shape}", k13_args,
                                epilogue.apply_epilogue(*k3_args))
            out = predict.synthesize_epilogue(*k13_args)
            log(f"(b) {label} bucket {bi} {shape}: K1+K3 == plain == K1 "
                f"then K3's torch ops ({r13[1]:.3f} ms vs {r13[2]:.1f} ms)")
            rp = ru = None
            if b.out_packed:
                rp = compare(f"K3b pack {label}[{bi}] {shape}",
                             lambda: epilogue.pack_int16_pairs(out),
                             lambda: epilogue.pack_int16_pairs_plain(out))
                compare(f"K3b pack per lane {label}[{bi}]",
                        lambda: epilogue.pack_int16_pairs(out, True),
                        lambda: epilogue.pack_int16_pairs_plain(out, True),
                        1)
                words, flag = epilogue.pack_int16_pairs(out)
                if int(flag) or not torch.equal(
                        epilogue.unpack_int16_pairs(words), out):
                    raise AssertionError(f"K3b {label}[{bi}]: the 16-bit "
                                         "bucket does not survive pack -> "
                                         "unpack")
                ru = compare(f"K3b unpack {label}[{bi}] {shape}",
                             lambda: epilogue.unpack_int16_pairs(words),
                             lambda: epilogue.unpack_int16_pairs_plain(
                                 words))
                # One PyTorch cast computes each function on a
                # little-endian host: held equal here, timed on the
                # headline bucket below, used nowhere in the port.
                if not (torch.equal(lib_unpack(words), out) and torch.equal(
                        lib_pack_words(out), words)):
                    raise AssertionError(f"K3b {label}[{bi}]: the library "
                                         "casts != the kernels")
                log(f"(b) {label} bucket {bi} {shape}: K3b pack == plain "
                    f"({rp[1]:.3f} ms vs {rp[2]:.2f} ms), unpack == plain "
                    f"({ru[1]:.3f} ms vs {ru[2]:.2f} ms), flag 0, pack -> "
                    "unpack == the bucket")
            else:
                log(f"(b) {label} bucket {bi} {shape}: does not pack")
            if label == "headline" and bi == 0:
                k2 = rows["K2_buckets"][-1]
                rows["K2"] = (r2[0], k2["ms"], r2[2])
                rows["K1"], rows["K1+K3"] = r1, r13
                rows["K3b_pack"], rows["K3b_unpack"] = rp, ru
                bounds["K3b_pack"] = bound(tensor_bytes(out, words, flag))
                bounds["K3b_unpack"] = bound(tensor_bytes(words, out))
                library["K3b_unpack"] = cuda_ms(lambda: lib_unpack(words),
                                                20)
                # pack's words only: the overflow flag would need a second
                # call.
                library["K3b_pack"] = cuda_ms(lambda: lib_pack_words(out),
                                              20)
                log(f"(b) headline bucket: library casts == K3b; "
                    f"w.view(int16).to(int32) "
                    f"{library['K3b_unpack']:.3f} ms, "
                    "out.to(int16).view(int32) (no flag) "
                    f"{library['K3b_pack']:.3f} ms")
                # K3 is the same torch ops on either device: hold the
                # card's result to the CPU's on this bucket.
                if not torch.equal(out.cpu(), epilogue.apply_epilogue(
                        *(t.cpu() for t in k3_args))):
                    raise AssertionError("K3: the card's result != the "
                                         "CPU's")
                k3_ms = cuda_ms(lambda: epilogue.apply_epilogue(*k3_args),
                                20)
                mb_ms = cuda_ms(lambda: unpack_mb(mb, b.n_parts_max, b.nc),
                                20)
                rows["K3"] = (0, k3_ms, k3_ms)
                rows["unpack_mb"] = (0, mb_ms, mb_ms)
                # The same, paced by the host as a decode's loop is.
                paced = rows.setdefault("paced", {})
                for name, fn in (
                        ("K1+K3",
                         lambda: predict.synthesize_epilogue(*k13_args)),
                        ("K3", lambda: epilogue.apply_epilogue(*k3_args)),
                        ("unpack_mb",
                         lambda: unpack_mb(mb, b.n_parts_max, b.nc))):
                    paced[name] = cuda_ms(fn, 20, queued=False)
                bounds["K3"] = bound(tensor_bytes(k3_args, out))
                bounds["unpack_mb"] = bound(tensor_bytes(mb, u))
                # The mb's int16 tail, which unpack_mb gives to K3b unpack
                # in one launch; then the whole mb unpack with the torch-op
                # form of the unpack in the kernel's place.
                tail = mb[:, 36:].contiguous()
                compare(f"K3b unpack mb tail {tuple(tail.shape)}",
                        lambda: epilogue.unpack_int16_pairs(tail),
                        lambda: epilogue.unpack_int16_pairs_plain(tail), 1)
                tail_ms = cuda_ms(
                    lambda: epilogue.unpack_int16_pairs(tail), 20)
                rows["unpack_mb_tail_ms"] = tail_ms
                pipeline_bits.unpack_int16_pairs = \
                    epilogue.unpack_int16_pairs_plain
                try:
                    mb_ops_ms = cuda_ms(
                        lambda: unpack_mb(mb, b.n_parts_max, b.nc), 20)
                finally:
                    pipeline_bits.unpack_int16_pairs = \
                        epilogue.unpack_int16_pairs
                rows["unpack_mb_torch_ops_ms"] = mb_ops_ms
                log(f"(b) headline bucket: K3 == its CPU result; alone "
                    f"{k3_ms:.3f} ms (bound "
                    f"{bounds['K3'][0]:.4f}), mb unpack alone {mb_ms:.3f} "
                    f"ms (bound {bounds['unpack_mb'][0]:.4f}; {mb_ops_ms:.3f}"
                    " ms with the torch-op unpack in the kernel's place), of "
                    f"which K3b unpack, one launch on the mb tail "
                    f"{tuple(tail.shape)}, {tail_ms:.3f} ms")
                bounds["K2"] = bound(tensor_bytes(k2_args, x))
                bounds["K1"] = bound(2 * tensor_bytes(x) + tensor_bytes(
                    k1_args[1:]), synth_ops(u["orders"], u["lengths"]))
                bounds["K1+K3"] = bound(2 * tensor_bytes(x) + tensor_bytes(
                    k13_args[1:]), synth_ops(u["orders"], u["lengths"]))
                log(f"(b) headline bucket: K1+K3 fused {r13[1]:.4f} ms "
                    f"against K1 {r1[1]:.4f} ms + K3's torch ops "
                    f"{k3_ms:.4f} ms = {r1[1] + k3_ms:.4f} ms; bound "
                    f"{bounds['K1+K3'][0]:.4f} ms ({bounds['K1+K3'][1]}); "
                    f"paced by the host: K1+K3 {paced['K1+K3']:.4f} ms, K3 "
                    f"{paced['K3']:.4f} ms, mb unpack "
                    f"{paced['unpack_mb']:.4f} ms")
                main_shape = shape
                n = bp.n_crc
                rows["main_dims"] = dict(
                    L=b.mb.shape[0], T=b.nc * 32, P=b.n_parts_max, SA=b.sa,
                    W=len(bp.stream), F=n,
                    B=int((bp.se[1][:n] - bp.se[0][:n]).max()))
                # K1's per-warp latency: the bucket's first 32 lanes alone
                # (one warp on the card) against the whole bucket.
                one = [t[:32].contiguous() for t in k1_args]
                one_ms = cuda_ms(lambda: predict.synthesize(*one), 20)
                log(f"(b) K1 on the first 32 lanes alone: {one_ms:.4f} ms "
                    f"({one_ms * 1e-3 * 1.98e9 / (b.nc * 32):.0f} cycles "
                    "per step at 1.98 GHz) against "
                    f"{r1[1]:.4f} ms for all {b.mb.shape[0]} lanes")
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
        rep = k4_report(f"{label} F={starts.shape[0]} W={stream.shape[0]}",
                        stream, starts, ends, r4, parent)
        if label == "headline":
            rows["paced"]["K4"] = cuda_ms(
                lambda: crc.crc16_ranges(stream, starts, ends), 20,
                queued=False)
            log(f"(b) headline K4 paced by the host: "
                f"{rows['paced']['K4']:.4f} ms")
            rows["K4"] = (r4[0], rep["ms"], r4[2])
            rows["K4_parent"] = rep
            # Output: one int32 per range, the size of starts.
            bounds["K4"] = bound(tensor_bytes(stream, starts, ends, starts))
            k4_shape = f"F={starts.shape[0]}"
            phase_b_crc(stream, parent)

    # K2 on every bucket of the generated corpus (edge-case files).
    bp = plan_raw_bits(extract_streams_bits(generated, native), 128)
    for bi, b in enumerate(bp.bits):
        stream, mb, _se = inputs_from_numpy(bp.stream, b.mb, bp.se, DEVICE)
        u = unpack_mb(mb, b.n_parts_max, b.nc)
        k2_args = (stream, u["bases"], u["ks"], u["ps"], u["orders"],
                   u["pbits"], u["flags"], u["warm"], u["lengths"])
        kw = dict(n_parts_max=b.n_parts_max, sa=b.sa)
        shape = f"L={b.mb.shape[0]} T={b.nc * 32} P={b.n_parts_max} " \
            f"SA={b.sa}"
        r2 = compare(f"K2 generated[{bi}] {shape}",
                     lambda: entropy.decode_residual_bits_stream(
                         *k2_args, **kw),
                     lambda: entropy.decode_residual_bits_stream_plain(
                         *k2_args, **kw), 1)
        log(f"(b) generated bucket {bi} {shape}: K2 == plain")

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

    # The redesign's tap classes: a warp whose lanes need every class
    # (orders 0, 1, 4, 8, 12, 32), coefficients nonzero only in column 0
    # (the warp must take all 32 taps), T from 1 to 4608 with L = 100 (not
    # a multiple of 32) and lengths below T.
    def k1_case(label, L, T, orders, col0=False, short=False):
        xs = rng.integers(-(1 << 31), 1 << 31, (L, T), dtype=np.int64)
        cs = rng.integers(-(1 << 15) + 1, 1 << 15, (L, 32))
        if col0:
            cs[:, 1:] = 0
        else:
            cs[np.arange(32)[None, :] < 32 - orders[:, None]] = 0
        lens = rng.integers(0, T, L) if short else np.full(L, T)
        args = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                .to(DEVICE) for a in (xs, cs, rng.integers(0, 32, L),
                                      orders, lens)]
        r = compare(f"K1 {label}", lambda: predict.synthesize(*args),
                    lambda: predict.synthesize_plain(*args), 1)
        log(f"(b) K1 {label} (L={L} T={T}): kernel == plain "
            f"({r[1]:.3f} ms)")

    mix = np.resize(np.array([0, 1, 4, 8, 12, 32]), 64)
    k1_case("tap classes mixed in each warp", 64, 1152, mix)
    k1_case("coefficients in column 0 only", 100, 576,
            rng.integers(0, 33, 100), col0=True)
    for T in (1, 192, 1152, 4096, 4608):
        k1_case("ragged lanes, lengths below T", 100, T,
                rng.integers(0, 33, 100), short=True)
    return rows, bounds, library, main_shape, k4_shape


def phase_b_fallback(datas):
    """The fused K1 + K3 kernel on every fallback-frame bucket the
    host-walk planner builds for each stream of ``datas`` alone, on the
    inputs decode_raw_bits_device gives it (an int16-pair upload unpacked
    by K3b first)."""
    from claxon_tpu_torch import native
    from claxon_tpu_torch.ops import epilogue, predict
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import _to_device, plan_raw_bits

    buckets = [s for data in datas for s in plan_raw_bits(
        extract_streams_bits([data], native), 128).samples]
    if sorted(s.in_packed for s in buckets) != [False, True]:
        raise AssertionError("the fallback corpus did not give one int16 "
                             "and one int32 fallback bucket")
    for si, s in enumerate(buckets):
        x, coefs, shifts, orders, wasted, pair_modes, lengths = (
            _to_device(a, DEVICE) for a in (
                s.x, s.coefs, s.shifts, s.orders, s.wasted, s.pair_modes,
                s.lengths))
        if s.in_packed:
            x = epilogue.unpack_int16_pairs(x)
        args = (x, coefs, shifts, orders, lengths, wasted, pair_modes)
        r = compare_fused(f"fallback bucket {si}", args,
                          epilogue.apply_epilogue(
                              predict.synthesize(*args[:5]), *args[5:]))
        log(f"(b) fallback bucket {si} L={x.shape[0]} T={x.shape[1]} "
            f"({'int16 pairs' if s.in_packed else 'int32'} upload): K1+K3 "
            f"== plain == K1 then K3's torch ops ({r[1]:.3f} ms vs "
            f"{r[2]:.1f} ms)")


def phase_b_pack16():
    """K3b edge cases against the plain forms, tolerance 0."""
    import numpy as np
    import torch

    from claxon_tpu_torch.ops import epilogue

    rng = np.random.default_rng(8)
    i32 = np.iinfo(np.int32)

    def quiet(L, T):
        return rng.integers(-32768, 32768, (L, T))

    cases = {}
    x = quiet(64, 576)
    x[:4, :4] = [[-32768, 32767, -32769, 32768]] * 4
    cases["the int16 boundaries and one past each"] = (x, 1)
    x = quiet(8, 4096)
    x[0, :2] = [-32768, 32767]
    cases["-32768 and 32767 alone"] = (x, 0)
    x = quiet(37, 192)
    x[5, 1], x[20, 190] = i32.max, i32.min
    cases["int32 extremes"] = (x, 1)
    x = quiet(6912, 4096)
    x[-1, -1] = 32768
    cases["one value out of range, last column of the last lane"] = (x, 1)
    cases["T = 2"] = (np.array([[5, -7], [-32768, 32767], [0, 70000]]), 1)
    cases["T = 6 (narrow vectors), 3 lanes"] = (
        rng.integers(-40000, 40000, (3, 6)), None)
    cases["garbage"] = (rng.integers(i32.min, i32.max + 1, (100, 4608),
                                     dtype=np.int64), 1)
    for label, (x, want_flag) in cases.items():
        x_np = np.ascontiguousarray(x, np.int32)
        x = torch.from_numpy(x_np).to(DEVICE)
        for per_lane in (False, True):
            compare(f"K3b pack, {label}",
                    lambda: epilogue.pack_int16_pairs(x, per_lane),
                    lambda: epilogue.pack_int16_pairs_plain(x, per_lane), 1)
        words, flag = epilogue.pack_int16_pairs(x)
        lanes = epilogue.pack_int16_pairs(x, per_lane=True)[1]
        oob = (x_np > 32767) | (x_np < -32768)
        if want_flag is not None and int(flag) != want_flag:
            raise AssertionError(f"K3b pack, {label}: flag {int(flag)}")
        if int(flag) != int(oob.any()) or not np.array_equal(
                lanes.cpu().numpy() != 0, oob.any(axis=1)):
            raise AssertionError(f"K3b pack, {label}: wrong flags")
        compare(f"K3b unpack, {label}",
                lambda: epilogue.unpack_int16_pairs(words),
                lambda: epilogue.unpack_int16_pairs_plain(words), 1)
        compare(f"K3b unpack of raw words, {label}",
                lambda: epilogue.unpack_int16_pairs(x),
                lambda: epilogue.unpack_int16_pairs_plain(x), 1)
        back = epilogue.unpack_int16_pairs(words).cpu().numpy()
        if not np.array_equal(back, x_np.astype(np.int16)):
            raise AssertionError(f"K3b, {label}: pack -> unpack is not the "
                                 "int16 wrap of the input")
        if not np.array_equal(words.cpu().numpy().view(np.int16),
                              x_np.astype(np.int16)):
            raise AssertionError(f"K3b, {label}: the host's int16 view of "
                                 "the words is not the input")
        log(f"(b) K3b {label} {tuple(x_np.shape)}: pack (scalar and "
            f"per-lane flags) and unpack == plain; flag {int(flag)}, "
            f"{int(lanes.sum())} lane(s) flagged")


def front_report(tag, args):
    """The fused front (bswap, K5, fields and compaction in two kernels,
    ``seg_parse.demux_front``) on one group's arguments: equal to its plain
    form and to the parent's seven operations (the bswap kernel, K5's
    three launches and torch.cumsum, the fields and compaction kernels) on
    every output, timed in the order parent, new, new, parent, with its
    byte bound. Returns a dict of the numbers."""
    import torch

    from claxon_tpu_torch.ops import seg_parse, segment

    words_le, n_bytes, ends, si_bps, T, nch, cap, wcap = args

    def new():
        return seg_parse.demux_front(*args)

    def parent():
        stream = seg_parse.bswap_words(words_le)
        pos, valid, count, win = segment.find_frame_headers(stream, n_bytes,
                                                            cap)
        return (stream, pos, valid, count, win) + seg_parse.parse_candidates(
            pos, valid, win, count, ends, si_bps, T, nch, wcap)

    r = compare(f"front {tag}", new,
                lambda: seg_parse.demux_front_plain(*args))
    if not all(torch.equal(a, b) for a, b in zip(flat_tensors(parent()),
                                                 flat_tensors(new()))):
        raise AssertionError(f"front {tag}: parent != new kernel")
    runs = [cuda_ms(parent, 10), cuda_ms(new, 20), cuda_ms(new, 20),
            cuda_ms(parent, 10)]
    out = new()
    nbytes = tensor_bytes(words_le, ends, si_bps, out[:3], out[4:])
    nb = bound(nbytes)
    rep = {"group": tag, "max_abs_err": r[0], "ms": (runs[1] + runs[2]) / 2,
           "plain_ms": r[2], "parent_ms": (runs[0] + runs[3]) / 2,
           "runs": runs, "bound_ms": nb[0], "bound_by": nb[1],
           "bytes": nbytes, "sync_hits": int(out[3]), "walkable": int(out[8][1])}
    log(f"(b) front {tag}: == plain and == the parent's seven operations, "
        f"every output; new {rep['ms']:.4f} ms, parent "
        f"{rep['parent_ms']:.4f} ms (runs parent, new, new, parent: "
        f"{', '.join(f'{t:.4f}' for t in runs)}); bound {nb[0]:.4f} ms "
        f"({nb[1]}); {rep['sync_hits']} sync hits, {rep['walkable']} "
        "walkable")
    return rep


def front_checked(label, fn):
    """Run ``fn()`` with ``seg_parse.demux_front`` recording its arguments
    (the decode calls it through the module), then hold the kernel to its
    plain form on every output of every recorded call. Returns (fn's
    result, the recorded arguments)."""
    from claxon_tpu_torch.ops import seg_parse

    calls = []
    front = seg_parse.demux_front

    def recording(*args):
        calls.append(args)
        return front(*args)

    # The wrapper counts its launches on the module's name.
    recording.launches = 0
    seg_parse.demux_front = recording
    try:
        out = fn()
    finally:
        seg_parse.demux_front = front
    if not calls:
        raise AssertionError(f"{label}: the fused front did not run")
    for i, args in enumerate(calls):
        r = compare(f"front {label}[{i}]", lambda: front(*args),
                    lambda: seg_parse.demux_front_plain(*args), 1)
        log(f"(b) front {label}[{i}] W={args[0].shape[0]} cap={args[6]} "
            f"wcap={args[7]} T={args[4]} nch={args[5]}: == plain, every "
            f"output ({r[1]:.3f} ms vs {r[2]:.1f} ms)")
    return out, calls


def phase_b_seg(datas4, mixed):
    """K5-K8 against their plain forms on the segmented path's own
    inputs: every group of the headline and mixed decodes (the fused front
    also against the parent's seven operations), and every K8
    dispatch."""
    import torch

    from claxon_tpu_torch import pipeline_bits, pipeline_seg
    from claxon_tpu_torch.ops import (crc, demux, epilogue, predict,
                                      seg_gather, seg_parse, segment)

    rows, bounds = {}, {}
    parent = k7_parent_walk()
    k4_parent = k4_parent_crc()
    log("(b) K7 " + ptxas_report(REPO / "claxon_tpu_torch" / "csrc" /
                                 "demux.cu"))
    log("(b) K5 + K6 " + ptxas_report(REPO / "claxon_tpu_torch" / "csrc" /
                                      "seg_parse.cu"))
    clock = None
    for label, datas in (("headline", datas4), ("mixed", mixed)):
        k8_calls, k1_calls, k4_calls = [], [], []
        dispatch = pipeline_seg._dispatch

        def recording_crc(stream, starts, ends):
            k4_calls.append((stream, starts, ends))
            return crc.crc16_ranges(stream, starts, ends)

        def recording(mode, stream, walk, rws, lengths, modes, tb32, *rest):
            device = rest[-1]
            rows_t = torch.from_numpy(rws).to(device)
            k8_calls.append((walk["values"], walk["warm"], walk["order"],
                             rows_t, tb32))
            k1_calls.append((walk, rows_t,
                             torch.from_numpy(lengths).to(device),
                             torch.from_numpy(modes[0::2].copy()).to(device)))
            return dispatch(mode, stream, walk, rws, lengths, modes, tb32,
                            *rest)

        # K4 launches through pipeline_bits on both paths (_crc_shards).
        pipeline_seg._dispatch = recording
        pipeline_bits.crc16_ranges = recording_crc
        try:
            pending = pipeline_seg.begin_segmented(datas, device=DEVICE)
            pipeline_seg.finish_segmented(pending).sync()
        finally:
            pipeline_seg._dispatch = dispatch
            pipeline_bits.crc16_ranges = crc.crc16_ranges
        if not k4_calls:
            raise AssertionError(f"{label}: the segmented decode ran no K4")
        for gi, (stream, starts, ends) in enumerate(k4_calls):
            r4 = compare(
                f"K4 segmented {label}[{gi}] F={starts.shape[0]}",
                lambda: crc.crc16_ranges(stream, starts, ends),
                lambda: crc.crc16_ranges_plain(stream, starts, ends))
            if crc.crc16_ranges(stream, starts, ends).any():
                raise AssertionError(f"K4 segmented {label}[{gi}]: an "
                                     "intact frame failed")
            log(f"(b) {label} segmented K4 group {gi} "
                f"F={starts.shape[0]} W={stream.shape[0]}: == plain "
                f"({r4[1]:.3f} ms vs {r4[2]:.1f} ms)")
            rep = k4_report(f"segmented {label}[{gi}] F={starts.shape[0]} "
                            f"W={stream.shape[0]}", stream, starts, ends, r4,
                            k4_parent)
            if label == "headline" and gi == 0:
                rows["K4_seg"] = (r4[0], rep["ms"], r4[2])
                rows["K4_seg_parent"] = rep
                bounds["K4_seg"] = bound(tensor_bytes(stream, starts, ends,
                                                      starts))
        for gi, group in enumerate(pending.groups):
            pend = group[-1]
            words_le, n_bytes, T, nch, ends, si_bps = pend._key
            cap, wcap = pend.cap, pend.wcap
            shape = (f"W={words_le.shape[0]} cap={cap} wcap={wcap} T={T} "
                     f"nch={nch}")
            tag = f"{label}[{gi}] {shape}"
            r6a = compare(f"K6 bswap {tag}",
                               lambda: seg_parse.bswap_words(words_le),
                               lambda: seg_parse.bswap_words_plain(words_le))
            stream = seg_parse.bswap_words(words_le)
            r5 = compare(
                f"K5 {tag}",
                lambda: segment.find_frame_headers(stream, n_bytes, cap),
                lambda: segment.find_frame_headers_plain(stream, n_bytes,
                                                         cap))
            pos, valid, count, win = segment.find_frame_headers(
                stream, n_bytes, cap)
            pargs = (pos, valid, win, count, ends, si_bps, T, nch, wcap)
            r6b = compare(
                f"K6 fields {tag}",
                lambda: seg_parse.parse_candidates(*pargs),
                lambda: seg_parse.parse_candidates_plain(*pargs))
            fields, lane_of, walk_in, counts = \
                seg_parse.parse_candidates(*pargs)
            front = front_report(tag, (words_le, n_bytes, ends, si_bps, T,
                                       nch, cap, wcap))
            rows.setdefault("front_groups", []).append(front)
            if label == "mixed":
                # The delta-writing K7 (the segmented delta route's) against
                # the plain walk, every output; the values-only K7 equal to
                # it on every output but the deltas.
                rd = compare(
                    f"K7 with deltas {tag}",
                    lambda: demux.walk_frames(stream, *walk_in, T, nch, True),
                    lambda: demux.walk_frames_plain(stream, *walk_in, T, nch,
                                                    True))
                with_d = demux.walk_frames(stream, *walk_in, T, nch, True)
                walk = demux.walk_frames(stream, *walk_in, T, nch)
                if "deltas" in walk[0] or not all(
                        torch.equal(a, b) for a, b in zip(
                            flat_tensors((walk[0], walk[1:])),
                            flat_tensors(({k: with_d[0][k]
                                           for k in demux.WALK_KEYS},
                                          with_d[1:])))):
                    raise AssertionError(f"K7 {tag}: the values-only walk "
                                         "!= the delta-writing walk")
                r7 = (rd[0], cuda_ms(lambda: demux.walk_frames(
                    stream, *walk_in, T, nch), 20), rd[2])
                log(f"(b) K7 with deltas {tag}: == plain, every output; "
                    f"{rd[1]:.3f} ms (values only {r7[1]:.3f} ms)")
            else:
                r7 = compare(
                    f"K7 {tag}",
                    lambda: demux.walk_frames(stream, *walk_in, T, nch),
                    lambda: demux.walk_frames_plain(stream, *walk_in, T,
                                                    nch))
            walk, end_bits, ok = demux.walk_frames(stream, *walk_in, T, nch)
            if clock is None:
                clock = sm_clock_under(
                    lambda: demux.walk_frames(stream, *walk_in, T, nch))
            k7 = k7_report(tag, stream, walk_in, T, nch, r7, parent, clock)
            rows.setdefault("K7_groups", []).append(dict(k7, group=tag))
            sargs = (pos, fields, lane_of, end_bits, ok, walk["n_parts"],
                     walk["sa_words"], nch)
            r6c = compare(
                f"K6 summary {tag}",
                lambda: seg_parse.pack_summary(*sargs),
                lambda: seg_parse.pack_summary_plain(*sargs))
            n_walk = int(counts[1])
            values_mb = walk["values"].numel() * 4 / 1e6
            r6 = (max(r6a[0], r6b[0], r6c[0]), r6a[1] + r6b[1] + r6c[1],
                  r6a[2] + r6b[2] + r6c[2])
            log(f"(b) {tag}: {int(count)} sync hits, {n_walk} walked "
                f"frames, {values_mb:.0f} MB of walk values; front == "
                f"plain ({front['ms']:.3f} ms vs {front['plain_ms']:.1f} "
                f"ms), summary == plain ({r6c[1]:.3f} ms vs {r6c[2]:.1f} "
                f"ms), K7 == plain ({r7[1]:.3f} ms vs {r7[2]:.1f} ms); "
                f"the parent's pieces == plain: K5 ({r5[1]:.3f} ms vs "
                f"{r5[2]:.1f} ms), K6 bswap {r6a[1]:.3f}, fields "
                f"{r6b[1]:.3f}")
            if label == "headline" and gi == 0:
                rows["seg_W"] = stream.shape[0]
                # K5's row is the fused front; K6's, the front and the
                # summary kernel, its two launches on the path.
                rows.update(K5=(front["max_abs_err"], front["ms"],
                                front["plain_ms"]),
                            K6=(max(front["max_abs_err"], r6c[0]),
                                front["ms"] + r6c[1],
                                front["plain_ms"] + r6c[2]),
                            K6_summary=r6c, K7=r7,
                            K5_K6_parent=(max(r5[0], r6a[0], r6b[0]),
                                          r5[1] + r6a[1] + r6b[1],
                                          r5[2] + r6a[2] + r6b[2]))
                rows["K7_deltas_ms"] = cuda_ms(lambda: demux.walk_frames(
                    stream, *walk_in, T, nch, True), 20)
                log(f"(b) K7 with deltas {tag}: "
                    f"{rows['K7_deltas_ms']:.4f} ms (values only "
                    f"{r7[1]:.4f} ms)")
                rows["seg_shape"] = shape
                bounds["K5"] = (front["bound_ms"], front["bound_by"])
                bounds["K6"] = bound(front["bytes"] + tensor_bytes(
                    sargs, seg_parse.pack_summary(*sargs)))
                bounds["K7"] = bound(tensor_bytes(
                    stream, walk_in, walk, end_bits, ok))
        if not k8_calls:
            raise AssertionError(f"{label}: the segmented decode ran no K8")
        for ci, args in enumerate(k8_calls):
            values, warm, order, rws, tb32 = args
            r8 = compare(
                f"K8 {label}[{ci}]",
                lambda: seg_gather.gather_values(*args),
                lambda: seg_gather.gather_values_plain(*args))
            log(f"(b) {label} K8 dispatch {ci} L={rws.shape[0]} "
                f"Tb={tb32} rows of {values.shape[1]}: K8 == plain "
                f"({r8[1]:.3f} ms vs {r8[2]:.1f} ms)")
            # K1's inputs in this dispatch, as _dispatch builds them.
            walk1, rows1, lengths1, modes1 = k1_calls[ci]
            args1 = (seg_gather.gather_values(*args),
                     *(walk1[k].index_select(0, rows1)
                       for k in ("coefs", "shift", "order")), lengths1)
            r1 = compare(f"K1 segmented {label}[{ci}]",
                         lambda: predict.synthesize(*args1),
                         lambda: predict.synthesize_plain(*args1))
            k3_1 = (walk1["wasted"].index_select(0, rows1), modes1)
            r13 = compare_fused(f"segmented {label}[{ci}]", args1 + k3_1,
                                epilogue.apply_epilogue(
                                    predict.synthesize(*args1), *k3_1))
            log(f"(b) {label} segmented K1 dispatch {ci} "
                f"L={args1[0].shape[0]} T={args1[0].shape[1]}: K1 == plain "
                f"({r1[1]:.3f} ms vs {r1[2]:.1f} ms); K1+K3 == plain == K1 "
                f"then K3's torch ops ({r13[1]:.3f} ms vs {r13[2]:.1f} ms)")
            if label == "headline" and ci == 0:
                rows["K8"] = r8
                rows["k8_shape"] = f"L={rws.shape[0]} Tb={tb32}"
                # Data-dependent: only the gathered rows of the walk
                # values (and their warm-up samples) are read.
                n = rws.shape[0]
                bounds["K8"] = bound(4 * (2 * n * tb32 + 34 * n))
    return rows, bounds


def phase_b_front(stream, fallback):
    """The fused front on the segmented decodes of the fallback corpus
    (its frames pass the front and fail the walk) and of one headline
    ``stream`` with the capacity classes forced to 8, so the pending demux
    regrows: kernel == plain at every capacity, every PCM bit-exact."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch.ops import seg_parse

    dd, _calls = front_checked("fallback corpus", lambda: (
        ct.decode_streams_device(fallback, segmentation="device",
                                 device=DEVICE)))
    check_decoded("fallback corpus, segmented", fallback, dd.to_host())
    log(f"(b) fallback corpus, segmented: fallback streams "
        f"{dd.fallback_streams}")
    pick = seg_parse.pick_cap, seg_parse.pick_wcap
    seg_parse.pick_cap = seg_parse.pick_wcap = lambda *a: 8
    try:
        dd, calls = front_checked("regrow", lambda: ct.decode_streams_device(
            [stream], segmentation="device", device=DEVICE))
    finally:
        seg_parse.pick_cap, seg_parse.pick_wcap = pick
    caps = [(a[6], a[7]) for a in calls]
    if caps[0] != (8, 8) or min(caps[-1]) <= 8 or dd.fallback_streams:
        raise AssertionError(f"regrow: capacities {caps}, fallback "
                             f"{dd.fallback_streams}")
    check_decoded("regrow, segmented", [stream], dd.to_host())
    log(f"(b) regrow: the demux ran at (cap, wcap) {caps}")


def phase_b_routes(datas4, mixed):
    """The entropy routes' kernels against their plain forms on their own
    inputs, timed on the card with their byte bounds: K9 on every bucket
    of the delta planner for the headline and mixed corpora, K10 and K2
    on every dispatch of the segmented delta and scan decodes of them.
    Returns (rows, bounds): per kernel its headline numbers (the largest
    headline bucket or dispatch) and the list of every bucket's."""
    import torch

    from claxon_tpu_torch import native, pipeline_seg
    from claxon_tpu_torch.ops import entropy
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import _to_device, plan_raw_bits

    rows, bounds = {}, {}
    csrc = REPO / "claxon_tpu_torch" / "csrc"
    log("(b) K9, K10 " + ptxas_report(csrc / "entropy_delta.cu"))
    log("(b) K9, K10 parent " + ptxas_report(csrc / "entropy_delta_parent.cu"))
    parents = entropy.parent_kernels()

    def report(key, tag, kernel, plain, args, kw, main):
        def new():
            return kernel(*args, **kw)

        r = compare(f"{key} {tag}", new, lambda: plain(*args, **kw))
        got = new()
        nb = bound(tensor_bytes(args, got))
        # chunks: L * NC, which picks the kernels' walk or sample launch.
        rep = {"bucket": tag, "chunks": got.numel() // 32, "ms": r[1],
               "plain_ms": r[2], "bound_ms": nb[0]}
        old_s = ""
        if key in parents:
            def parent():
                return parents[key](*args, **kw)

            if not torch.equal(parent(), got):
                raise AssertionError(f"{key} {tag}: parent != new kernel")
            runs = [cuda_ms(parent, 20), cuda_ms(new, 20), cuda_ms(new, 20),
                    cuda_ms(parent, 20)]
            rep.update(ms=(runs[1] + runs[2]) / 2,
                       parent_ms=(runs[0] + runs[3]) / 2, runs=runs)
            r = (r[0], rep["ms"], r[2])
            old_s = (f"; parent {rep['parent_ms']:.4f} ms (runs parent, new, "
                     f"new, parent: {', '.join(f'{t:.4f}' for t in runs)}), "
                     "outputs equal")
        log(f"(b) {key} {tag}: == plain ({r[1]:.4f} ms vs {r[2]:.1f} ms)"
            f"{old_s}; bound {nb[0]:.4f} ms ({nb[1]})")
        rows.setdefault(key + "_buckets", []).append(rep)
        if main:
            rows[key], bounds[key] = r, nb
            rows[key + "_shape"] = tag
            rows[key + "_main"] = rep

    # K9: the host-walk delta planner's buckets, one per (T, nch, SA).
    for label, datas in (("headline", datas4), ("mixed", mixed)):
        bp = plan_raw_bits(extract_streams_bits(datas, native, "delta"), 128,
                           "delta")
        big = max(range(len(bp.bits)), key=lambda i: bp.bits[i].meta.shape[0])
        for bi, b in enumerate(bp.bits):
            m = _to_device(b.meta, DEVICE)
            args = (_to_device(b.slots, DEVICE),
                    torch.from_numpy(b.deltas).to(DEVICE),
                    _to_device(b.ks, DEVICE), m[:, 3].contiguous(),
                    m[:, 0].contiguous(), m[:, 4].contiguous(),
                    (m[:, 5] & 1).contiguous(), m[:, 8:40].contiguous())
            tag = (f"{label}[{bi}] L={b.meta.shape[0]} T={b.nc * 32} "
                   f"P={b.n_parts_max} SA={b.sa}")
            report("K9", tag, entropy.decode_residual_bits,
                   entropy.decode_residual_bits_plain, args,
                   dict(n_parts_max=b.n_parts_max, sa=b.sa),
                   label == "headline" and bi == big)

    # K10 and K2 on the segmented delta and scan dispatches: their inputs
    # recorded as finish_segmented hands them over.
    for mode, name, key in (("delta", "decode_residual_bits_stream_delta",
                             "K10"),
                            ("scan", "decode_residual_bits_stream",
                             "K2_scan")):
        fn = getattr(entropy, name)
        plain = getattr(entropy, name + "_plain")
        for label, datas in (("headline", datas4), ("mixed", mixed)):
            calls = []

            def recording(*args, **kw):
                calls.append((args, kw))
                return fn(*args, **kw)

            # The wrapper counts its launches on the module's name.
            recording.launches = 0
            setattr(entropy, name, recording)
            os.environ["CLAXON_TPU_SEG_ENTROPY"] = mode
            try:
                pipeline_seg.decode_streams_segmented(
                    datas, device=DEVICE).sync()
            finally:
                setattr(entropy, name, fn)
                del os.environ["CLAXON_TPU_SEG_ENTROPY"]
            if not calls:
                raise AssertionError(f"{label}: the segmented {mode} "
                                     f"decode ran no {key}")
            big = max(range(len(calls)),
                      key=lambda i: calls[i][0][1].shape[0])
            for ci, (args, kw) in enumerate(calls):
                L, NC = args[1].shape
                tag = (f"{label}[{ci}] L={L} T={NC * 32} "
                       f"P={kw['n_parts_max']} SA={kw['sa']}")
                report(key, tag, fn, plain, args, kw,
                       label == "headline" and ci == big)
    return rows, bounds


def check_decoded(label, datas, results):
    """Every PCM equals the scalar decoder's, and its MD5 where stored."""
    import numpy as np

    from claxon_tpu_torch import native
    from claxon_tpu_torch.testing import pcm_md5

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
    from claxon_tpu_torch import native
    from claxon_tpu_torch.native.binding import _read_metadata

    _si, bb = native.extract_stream_bits(data, emit_slots=False)
    _si, pos = _read_metadata(data)
    bad = bytearray(data)
    bad[pos + int(bb.bframes[0]["byte1"]) - 1] ^= 0xFF
    return bytes(bad)


def phase_b_rice_crc(datas4, dims):
    """The JAX package's three device functions that no decode route
    calls, rice_decode (csrc/rice.cu), crc16_device and
    crc16_frames_device (csrc/crc_lanes.cu): each kernel against its plain
    form on the CPU tests' garbage and edge cases (claxon_tpu_torch/
    testing/rice_crc_cases.py) and at the headline x4 shapes ``dims`` (the
    host walk's main bucket: L lanes of P partitions, T): rice_decode over
    L x P partitions of T / P codes of a buffer made from a seed, also
    held to the values that made it; crc16_device on the (F, B) byte
    matrix of the headline upload's frames, stored CRC included (every
    row 0); crc16_frames_device on that upload with the host walk's frame
    ranges (every frame 0, and equal to K4). rice_decode and
    crc16_frames_device are also held to their parent kernels
    (csrc/rice_parent.cu, csrc/crc_lanes_parent.cu) on every case and
    timed beside them, parent, new, new, parent. Returns (rows, bounds)
    keyed by the function's name."""
    import numpy as np
    import torch

    from claxon_tpu_torch import native
    from claxon_tpu_torch.ops import crc, rice
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import plan_raw_bits
    from claxon_tpu_torch.testing import rice_crc_cases as cases

    csrc = REPO / "claxon_tpu_torch" / "csrc"
    log("(b) rice_decode " + ptxas_report(csrc / "rice.cu"))
    log("(b) rice_decode parent " + ptxas_report(csrc / "rice_parent.cu"))
    log("(b) crc16_device, crc16_frames_device " +
        ptxas_report(csrc / "crc_lanes.cu"))
    log("(b) crc16_frames_device parent " +
        ptxas_report(csrc / "crc_lanes_parent.cu"))
    rice_parent = rice.parent_kernel()
    windows_parent = crc.parent_windows_kernel()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(DEVICE)

    def same(name, got, old):
        if not all(torch.equal(g, o) for g, o in zip(flat_tensors(got),
                                                     flat_tensors(old))):
            raise AssertionError(f"{name}: kernel != its parent")

    for call in cases.rice_calls() + cases.rice_edge_calls():
        words, sb, ks, cs, T = call["args"]
        T = max(int(cs.max()), 0) if T is None else T
        args = [dev(a) for a in (words, sb, ks, cs)]
        name = f"rice_decode on {', '.join(call['labels'])}"
        compare(name, lambda: rice.rice_decode(*args, max_count=T),
                lambda: rice.rice_decode_plain(*args, T), 1)
        same(name, rice.rice_decode(*args, max_count=T),
             rice_parent(*args, T))
    for call in cases.crc16_rows_calls():
        args = [dev(a) for a in call["args"]]
        compare(f"crc16_device on {', '.join(call['labels'])}",
                lambda: crc.crc16_device(*args),
                lambda: crc.crc16_device_plain(*args), 1)
    for call in cases.crc16_windows_calls() + \
            cases.crc16_windows_edge_calls():
        stream, starts, ends, n_words = call["args"]
        args = [dev(a) for a in (stream, starts, ends)]
        name = f"crc16_frames_device on {', '.join(call['labels'])}"
        compare(name, lambda: crc.crc16_frames_device(*args, n_words),
                lambda: crc.crc16_frames_device_plain(*args, n_words), 1)
        same(name, crc.crc16_frames_device(*args, n_words),
             windows_parent(*args, n_words))
    log("(b) rice_decode, crc16_device and crc16_frames_device == plain on "
        "every garbage and edge case; rice_decode and crc16_frames_device "
        "== their parents there")

    def beside_parent(name, new, old):
        """Times new and parent on the same inputs (parent, new, new,
        parent), their outputs equal."""
        same(name, new(), old())
        runs = [cuda_ms(old, 20), cuda_ms(new, 20), cuda_ms(new, 20),
                cuda_ms(old, 20)]
        return {"ms": (runs[1] + runs[2]) / 2,
                "parent_ms": (runs[0] + runs[3]) / 2, "runs": runs}

    rows, bounds = {}, {}
    n_parts, codes = dims["L"] * dims["P"], dims["T"] // dims["P"]
    t0 = time.perf_counter()
    st = cases.rice_stream(np.full(n_parts, codes), seed=1100)
    gen_s = time.perf_counter() - t0
    args = [dev(st[k]) for k in ("words", "start_bits", "params", "counts")]
    # max_count given: without it the wrapper reads max(counts) from the
    # card, a sync that would pace the timed launches.
    name = f"rice_decode {n_parts} x {codes}"
    r = compare(name, lambda: rice.rice_decode(*args, max_count=codes),
                lambda: rice.rice_decode_plain(*args, codes))
    out, end = rice.rice_decode(*args, max_count=codes)
    if not np.array_equal(out.cpu().numpy(), st["values"]) or \
            not np.array_equal(end.cpu().numpy()[:-1], st["start_bits"][1:]):
        raise AssertionError("rice_decode: != the values that made the "
                             "buffer")
    bounds["rice_decode"] = bound(tensor_bytes(args, out, end))
    par = beside_parent(name, lambda: rice.rice_decode(*args,
                                                       max_count=codes),
                        lambda: rice_parent(*args, codes))
    rows["rice_decode"] = (r[0], par["ms"], r[2])
    # One warp alone (its 32 lanes' chains, nothing to hide them behind)
    # against the whole input: how much of the time is one lane's chain.
    one = [args[0]] + [a[:32] for a in args[1:]]
    par_one = beside_parent(f"{name}, 32 lanes",
                            lambda: rice.rice_decode(*one, max_count=codes),
                            lambda: rice_parent(*one, codes))
    rows["rice_decode_parent"] = dict(
        par, one_warp_ms=par_one["ms"],
        parent_one_warp_ms=par_one["parent_ms"],
        one_warp_runs=par_one["runs"])
    one_ms = rows["rice_decode_one_warp_ms"] = par_one["ms"]

    def cycles(ms):
        return ms * 1e-3 * 1.98e9 / codes

    log(f"(b) rice_decode on {n_parts} partitions of {codes} codes (W="
        f"{st['words'].size}, made in {gen_s:.1f} s): == plain == parent "
        f"== the values that made the buffer; {par['ms']:.4f} ms, parent "
        f"{par['parent_ms']:.4f} ms (runs parent, new, new, parent: "
        f"{', '.join(f'{t:.4f}' for t in par['runs'])}); plain "
        f"{r[2]:.1f} ms; bound {bounds['rice_decode'][0]:.4f} ms "
        f"({bounds['rice_decode'][1]}); the first 32 lanes alone "
        f"{one_ms:.4f} ms ({cycles(one_ms):.0f} cycles per step at 1.98 "
        f"GHz), parent {par_one['parent_ms']:.4f} ms "
        f"({cycles(par_one['parent_ms']):.0f})")
    del st, out, end, args

    bp = plan_raw_bits(extract_streams_bits(datas4, native), 128)
    n = bp.n_crc
    s_np, e_np = bp.se[0][:n].astype(np.int64), bp.se[1][:n].astype(np.int64)
    B = int((e_np - s_np).max())
    upload = np.frombuffer(bp.stream.astype(">i4").tobytes(), np.uint8)
    at = np.minimum(s_np[:, None] + np.arange(B)[None, :], upload.size - 1)
    data, lengths = dev(upload[at]), dev(e_np - s_np)
    rows["crc16_device"] = compare(
        f"crc16_device ({n}, {B})", lambda: crc.crc16_device(data, lengths),
        lambda: crc.crc16_device_plain(data, lengths))
    if crc.crc16_device(data, lengths).any():
        raise AssertionError("crc16_device: an intact frame failed")
    # The bytes the function needs: each row's first clamp(lengths, 0, B)
    # elements (all the kernel reads of the padded matrix), the lengths
    # and the output.
    bounds["crc16_device"] = bound(
        4 * int(lengths.clamp(0, B).sum()) + tensor_bytes(lengths, lengths))
    log(f"(b) crc16_device on the headline frames ({n}, {B}): == plain, "
        f"every frame 0; {rows['crc16_device'][1]:.4f} ms (plain "
        f"{rows['crc16_device'][2]:.1f} ms), bound "
        f"{bounds['crc16_device'][0]:.4f} ms ({bounds['crc16_device'][1]})")
    del data, at

    stream = dev(bp.stream)
    starts, ends = dev(bp.se[0]), dev(bp.se[1])
    n_words = 1 << max(0, (B + 3) // 4 - 1).bit_length()
    name = f"crc16_frames_device (F={starts.shape[0]}, n_words={n_words})"
    r = compare(name,
                lambda: crc.crc16_frames_device(stream, starts, ends,
                                                n_words),
                lambda: crc.crc16_frames_device_plain(stream, starts, ends,
                                                      n_words))
    got = crc.crc16_frames_device(stream, starts, ends, n_words)
    if got[:n].any() or not torch.equal(got, crc.crc16_ranges(stream, starts,
                                                               ends)):
        raise AssertionError("crc16_frames_device: an intact frame failed, "
                             "or != K4 on the same ranges")
    bounds["crc16_frames_device"] = bound(tensor_bytes(stream, starts, ends,
                                                       got))
    par = beside_parent(
        name, lambda: crc.crc16_frames_device(stream, starts, ends, n_words),
        lambda: windows_parent(stream, starts, ends, n_words))
    rows["crc16_frames_device"] = (r[0], par["ms"], r[2])
    k4_ms = cuda_ms(lambda: crc.crc16_ranges(stream, starts, ends), 20)
    rows["crc16_frames_device_parent"] = dict(par, k4_ms=k4_ms)
    log(f"(b) crc16_frames_device on the headline upload (W="
        f"{stream.shape[0]}, F={starts.shape[0]}, n_words={n_words}): == "
        f"plain == parent == K4, every frame 0; {par['ms']:.4f} ms, parent "
        f"{par['parent_ms']:.4f} ms (runs parent, new, new, parent: "
        f"{', '.join(f'{t:.4f}' for t in par['runs'])}); K4 on the same "
        f"ranges {k4_ms:.4f} ms; plain {r[2]:.1f} ms; bound "
        f"{bounds['crc16_frames_device'][0]:.4f} ms "
        f"({bounds['crc16_frames_device'][1]})")
    return rows, bounds


def build_parent(label, src):
    """The ctypes library of a parent kernel built from ``src`` with the
    port's flags, or None when that file is absent. Its ptxas report is
    printed."""
    import ctypes

    from claxon_tpu_torch.ops import _build

    if not src.exists():
        return None
    so = src.with_name(f"lib{src.parent.name}.so")
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True, timeout=600,
                   capture_output=True)
    log(f"(b) {label} parent kernel built from {src.relative_to(REPO)}; "
        + ptxas_report(src))
    return ctypes.CDLL(str(so))


@functools.lru_cache(maxsize=None)
def k2_parent_entropy():
    """K2's parent kernel (``K2_PARENT_SRC``), or None when that file is
    absent; see ``k2_kernel``."""
    return k2_kernel("K2", K2_PARENT_SRC)


def k2_kernel(label, src):
    """K2 built from ``src`` as a callable with decode_residual_bits_
    stream's arguments and result; None when that file is absent."""
    import ctypes

    import torch

    from claxon_tpu_torch.ops import _build

    lib = build_parent(label, src)
    if lib is None:
        return None
    fn = lib.cxk_entropy_stream
    fn.argtypes = _build._SIGNATURES["cxk_entropy_stream"]
    fn.restype = ctypes.c_int

    def entropy(stream, bases, ks, ps, orders, pbits, flags, warm, lengths,
                n_parts_max=1, sa=8):
        L, NC = bases.shape
        out = torch.empty((L, NC * 32), dtype=torch.int32,
                          device=stream.device)
        _build.check(fn(stream.data_ptr(), stream.shape[0], bases.data_ptr(),
                        ks.data_ptr(), ks.shape[1], n_parts_max,
                        ps.data_ptr(), orders.data_ptr(), pbits.data_ptr(),
                        flags.data_ptr(), warm.data_ptr(), warm.shape[1],
                        lengths.data_ptr(), out.data_ptr(), L, NC, sa,
                        _build.stream_handle(stream.device)),
                     f"{label} cxk_entropy_stream")
        return out

    return entropy


@functools.lru_cache(maxsize=None)
def k4_parent_crc():
    """K4's parent kernel as a callable with crc16_ranges' arguments and
    result, built from ``K4_PARENT_SRC``; None when that file is absent."""
    import ctypes

    import torch

    from claxon_tpu_torch.ops import _build

    lib = build_parent("K4", K4_PARENT_SRC)
    if lib is None:
        return None
    fn = lib.cxk_crc16_ranges
    P, N = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [P, N, P, P, P, N, P]
    fn.restype = ctypes.c_int

    def crc16(stream, starts, ends):
        out = torch.empty(starts.shape, dtype=torch.int32,
                          device=stream.device)
        _build.check(fn(stream.data_ptr(), stream.shape[0],
                        starts.data_ptr(), ends.data_ptr(), out.data_ptr(),
                        starts.shape[0], _build.stream_handle(stream.device)),
                     "parent cxk_crc16_ranges")
        return out

    return crc16


def k7_parent_walk():
    """K7's parent kernel as a callable with walk_frames' arguments and
    results, built from ``K7_PARENT_SRC``; None when that file is absent."""
    import ctypes

    import torch

    from claxon_tpu_torch.ops import _build, demux

    lib = build_parent("K7", K7_PARENT_SRC)
    if lib is None:
        return None
    fn = lib.cxk_walk_frames
    P, N = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [P, N, P, P, P, P, N, N, N] + [P] * 16
    fn.restype = ctypes.c_int

    def walk(stream, start_bits, bs, modes, bps0, T, nch):
        dev = stream.device
        F = start_bits.shape[0]
        out = {k: torch.empty(sh, dtype=torch.int32, device=dev)
               for k, sh in demux._lane_shapes(F * nch, T).items()}
        end_bits = torch.empty((F,), dtype=torch.int32, device=dev)
        ok = torch.empty((F,), dtype=torch.bool, device=dev)
        _build.check(fn(stream.data_ptr(), stream.shape[0],
                        start_bits.data_ptr(), bs.data_ptr(), modes.data_ptr(),
                        bps0.data_ptr(), F, T, nch,
                        *(out[k].data_ptr() for k in demux.WALK_KEYS),
                        end_bits.data_ptr(), ok.data_ptr(),
                        _build.stream_handle(dev)), "parent cxk_walk_frames")
        return out, end_bits, ok

    return walk


def ptxas_report(src):
    """Registers, shared memory and spills of each kernel in ``src``, from
    ``nvcc -Xptxas -v`` (one line per kernel)."""
    from claxon_tpu_torch.ops import _build

    err = subprocess.run([_build._nvcc(), *_build._FLAGS, "-Xptxas", "-v",
                          "-c", "-o", "/dev/null", str(src)], check=True,
                         timeout=600, capture_output=True, text=True).stderr
    lines, name = [], None
    for line in err.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line):
            lines.append(f"{name}: {line.split(' : ')[-1].strip()}")
    return "ptxas: " + "; ".join(lines)


def sm_clock_under(fn, calls=1500):
    """(clocks.sm, clocks.max.sm) in MHz from nvidia-smi, read while the
    card runs ``calls`` queued calls of ``fn``."""
    import torch

    proc = None
    for i in range(calls):
        fn()
        if i == calls // 5:
            proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                 "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
                text=True)
    out = proc.communicate(timeout=60)[0]
    torch.cuda.synchronize()
    cur, mx = out.strip().splitlines()[0].split(",")
    return int(cur), int(mx)


def k7_report(tag, stream, walk_in, T, nch, r7, parent, clock):
    """K7 at one segmented group: its time beside the parent kernel's on
    the same inputs (outputs equal), its byte bound, cycles per step (of
    the longest frame's codes, at the SM clock read under load). Returns a
    dict of the numbers."""
    import torch

    from claxon_tpu_torch.ops import demux

    def new():
        return demux.walk_frames(stream, *walk_in, T, nch)

    got = new()
    nb = bound(tensor_bytes(stream, walk_in, got))
    nc32 = (T + 31) // 32 * 32
    steps = nch * int(walk_in[1].clamp(0, nc32).max())
    rep = {"ms": r7[1], "bound_ms": nb[0], "steps": steps,
           "sm_clock_mhz": clock[0], "sm_clock_max_mhz": clock[1],
           "cycles_per_step": r7[1] * 1e3 * clock[0] / max(steps, 1),
           "parent_ms": None}
    if parent is not None:
        old = parent(stream, *walk_in, T, nch)
        for a, b in zip(flat_tensors(old), flat_tensors(got)):
            if not torch.equal(a, b):
                raise AssertionError(f"K7 {tag}: parent != new kernel")
        # parent, new, new, parent
        t_old = cuda_ms(lambda: parent(stream, *walk_in, T, nch), 5)
        t_new = cuda_ms(new, 20)
        t_new2 = cuda_ms(new, 20)
        t_old2 = cuda_ms(lambda: parent(stream, *walk_in, T, nch), 5)
        rep.update(parent_ms=(t_old + t_old2) / 2, ms=(t_new + t_new2) / 2,
                   parent_runs=[t_old, t_old2], new_runs=[t_new, t_new2])
        rep["cycles_per_step"] = rep["ms"] * 1e3 * clock[0] / max(steps, 1)
    old_s = ("not built (no parent source)" if rep["parent_ms"] is None
             else f"{rep['parent_ms']:.4f} ms (runs {t_old:.4f}, "
             f"{t_old2:.4f}; new {t_new:.4f}, {t_new2:.4f}), outputs equal")
    log(f"(b) K7 {tag}: new {rep['ms']:.4f} ms; parent {old_s}; bound "
        f"{nb[0]:.4f} ms ({nb[1]}); {rep['cycles_per_step']:.1f} cycles per "
        f"step ({steps} steps in the longest frame, SM clock {clock[0]} MHz "
        f"under load, max {clock[1]})")
    return rep


def overflow_stream():
    """A 16-bit stream (3 frames of 4096) with one damaged byte in frame
    1's first subframe and that frame's CRC-16 repaired, so it parses and
    passes every CRC, and decodes to garbage far outside int16 (found by
    a seeded search on the CPU; checked again by the caller)."""
    from claxon_tpu_torch import native
    from claxon_tpu_torch.native.binding import _read_metadata
    from claxon_tpu_torch.testing import encode_flac, synth_music

    data = encode_flac(synth_music(4096 * 3, channels=2, bps=16, seed=3000),
                       44100, 16, block_size=4096)
    _si, bb = native.extract_stream_bits(data, emit_slots=False)
    _si, pos = _read_metadata(data)
    b0 = pos + int(bb.bframes[1]["byte0"])
    b1 = pos + int(bb.bframes[1]["byte1"])
    bad = bytearray(data)
    bad[b0 + 27] ^= 13
    bad[b1 - 2:b1] = native.crc16_bytes(bytes(bad[b0:b1 - 2])) \
        .to_bytes(2, "big")
    return bytes(bad)


def fetch_stats(dd):
    """(buckets, buckets fetched as int16 pairs, buckets refetched as
    int32 after the overflow flag, bytes copied back) of a DeviceDecoded
    after to_host()."""
    packed = refetched = nbytes = 0
    for d in dd.dispatches:
        if d.packed:
            packed += 1
            nbytes += tensor_bytes(d.words, d.flag)
            refetched += d.host is not None
        nbytes += tensor_bytes(d.host)
    return len(dd.dispatches), packed, refetched, nbytes


def large_source():
    """(stream, pcm): the LARGE_SOURCE_FRAMES distinct frames of the large
    stream as a stream of their own (8 channels, 24-bit, 96 kHz, FIXED
    subframes, rice2, block size 4096), from the port's encoder."""
    import numpy as np

    from claxon_tpu_torch.testing import encode_flac, synth_music

    bs, nch, bps, rate = 4096, 8, 24, 96000
    pcm = synth_music(bs * LARGE_SOURCE_FRAMES, channels=nch, bps=bps,
                      seed=4000, sample_rate=rate).astype(np.int32)
    return encode_flac(pcm, rate, bps, block_size=bs, force_subframe="fixed",
                       rice2=True, partition_order=2), pcm


def large_stream():
    """(stream, pcm): one valid FLAC stream of at least LARGE_MIN_BYTES
    bytes and its PCM. The frames of ``large_source()`` (poor compression,
    every frame on the bits path, so through K2) repeat in order under new
    frame numbers, each with its CRC-8 and CRC-16 recomputed, and
    STREAMINFO gets the new sample count, frame sizes and PCM MD5."""
    import numpy as np

    from claxon_tpu_torch import native
    from claxon_tpu_torch.crc import crc8
    from claxon_tpu_torch.native.binding import _read_metadata
    from claxon_tpu_torch.testing import pcm_md5
    from claxon_tpu_torch.testing.flacgen import _utf8_like

    bs, nch, bps, rate = 4096, 8, 24, 96000
    src, pcm = large_source()
    _si, pos = _read_metadata(src)
    _si, bb = native.extract_stream_bits(src, emit_slots=False)
    if (bb.bframes["flags"] & 1).any():
        raise AssertionError("large stream: a source frame left the bits "
                             "path")
    parts = []  # (sync and codes, subframes) of each source frame
    for k, f in enumerate(bb.bframes):
        raw = src[pos + int(f["byte0"]):pos + int(f["byte1"])]
        parts.append((raw[:4], raw[4 + len(_utf8_like(k)) + 1:-2]))
    frames, total = [], 0
    while total < LARGE_MIN_BYTES:
        head, body = parts[len(frames) % len(parts)]
        hdr = head + _utf8_like(len(frames))
        fr = hdr + bytes([crc8(hdr)]) + body
        fr += native.crc16_bytes(fr).to_bytes(2, "big")
        frames.append(fr)
        total += len(fr)
    n = len(frames) * bs
    full = np.tile(pcm, (-(-len(frames) // len(parts)), 1))[:n]
    si = bytearray(src[8:42])  # STREAMINFO body (the first block)
    if src[4] & 0x7F != 0:
        raise AssertionError("large stream: STREAMINFO is not first")
    sizes = [len(f) for f in frames]
    si[4:7] = min(sizes).to_bytes(3, "big")
    si[7:10] = max(sizes).to_bytes(3, "big")
    si[10:18] = ((rate << 44) | ((nch - 1) << 41) | ((bps - 1) << 36)
                 | n).to_bytes(8, "big")
    si[18:34] = pcm_md5(full, bps)
    data = src[:8] + bytes(si) + src[42:pos] + b"".join(frames)
    return data, full


def phase_f():
    """One stream of at least 2^27 bytes through both paths' public calls:
    it walks in chunks of frames (the segmented path hands it to the host
    walk whole), bit-exact against the scalar decoder and the MD5."""
    import numpy as np

    import torch

    import claxon_tpu_torch as ct
    from claxon_tpu_torch import native, pipeline_bits
    from claxon_tpu_torch.ops import crc, demux, entropy, seg_parse
    from claxon_tpu_torch.pipeline_bits import MAX_BATCH_BYTES
    from claxon_tpu_torch.testing import pcm_md5

    t0 = time.perf_counter()
    data, pcm = large_stream()
    gen_s = time.perf_counter() - t0
    if len(data) < max(LARGE_MIN_BYTES, MAX_BATCH_BYTES):
        raise AssertionError(f"large stream: only {len(data)} bytes")
    log(f"(f) large stream: {len(data)} bytes, {pcm.shape[0]} samples x "
        f"{pcm.shape[1]} channels, 24-bit; generated in {gen_s:.1f} s")
    t0 = time.perf_counter()
    si, want = native.decode_stream_scalar(data)
    if not np.array_equal(want, pcm):
        raise AssertionError("large stream: scalar decoder != source PCM")
    if pcm_md5(want, si.bits_per_sample) != si.md5sum:
        raise AssertionError("large stream: scalar decoder MD5 mismatch")
    log(f"(f) large stream: scalar decoder == source PCM == STREAMINFO MD5 "
        f"({time.perf_counter() - t0:.1f} s)")
    k4_calls, k2_calls = [], []

    def recording_crc(stream, starts, ends):
        k4_calls.append((stream, starts, ends))
        return crc.crc16_ranges(stream, starts, ends)

    def recording_k2(*args, **kw):
        k2_calls.append((args, kw))
        return entropy.decode_residual_bits_stream(*args, **kw)

    for path in ("host", "device"):
        entropy.decode_residual_bits_stream.launches = 0
        t0 = time.perf_counter()
        if path == "host":
            pipeline_bits.crc16_ranges = recording_crc
            pipeline_bits.decode_residual_bits_stream = recording_k2
        try:
            dd = ct.decode_streams_device([data], segmentation=path,
                                          device=DEVICE)
        finally:
            pipeline_bits.crc16_ranges = crc.crc16_ranges
            pipeline_bits.decode_residual_bits_stream = \
                entropy.decode_residual_bits_stream
        runs = len(dd.crc_check or [])  # one CRC dispatch per run
        dec = dd.to_host()[0]
        dt = time.perf_counter() - t0
        if not np.array_equal(dec.pcm, want):
            raise AssertionError(f"large stream, {path}: PCM != scalar "
                                 "decoder")
        if pcm_md5(dec.pcm, si.bits_per_sample) != si.md5sum:
            raise AssertionError(f"large stream, {path}: MD5 mismatch")
        k2 = entropy.decode_residual_bits_stream.launches
        if runs < 2 or k2 < 1:
            raise AssertionError(f"large stream, {path}: {runs} runs, "
                                 f"{k2} K2 launches")
        log(f"(f) large stream, {path} path: bit-exact vs the scalar "
            f"decoder and the MD5; {runs} runs below the "
            f"{MAX_BATCH_BYTES}-byte limit, {k2} K2 launches, "
            f"{dt:.1f} s to host")
    # K4 on each run's frame ranges (the longest frames of any corpus).
    parent = k4_parent_crc()
    for i, (stream, starts, ends) in enumerate(k4_calls):
        r4 = compare(f"K4 large stream run {i}",
                     lambda: crc.crc16_ranges(stream, starts, ends),
                     lambda: crc.crc16_ranges_plain(stream, starts, ends), 1)
        k4_report(f"large stream run {i} F={starts.shape[0]} "
                  f"W={stream.shape[0]}", stream, starts, ends, r4, parent)
    if not k4_calls:
        raise AssertionError("large stream: the host walk ran no K4")
    log(f"(f) large stream: K4 == plain on the frame ranges of its "
        f"{len(k4_calls)} runs")
    # K2 on each bucket of each run, beside its parent.
    if not k2_calls:
        raise AssertionError("large stream: the host walk ran no K2")
    k2_parent = k2_parent_entropy()
    k2_reps = []
    for i, (args, kw) in enumerate(k2_calls):
        L, NC = args[1].shape
        tag = (f"large stream bucket {i} L={L} T={NC * 32} "
               f"P={kw['n_parts_max']} SA={kw['sa']} W={args[0].shape[0]}")
        r2 = compare(f"K2 {tag}",
                     lambda: entropy.decode_residual_bits_stream(*args, **kw),
                     lambda: entropy.decode_residual_bits_stream_plain(
                         *args, **kw), 1)
        k2_reps.append(k2_report(tag, args, kw, r2, k2_parent))
    del k2_calls
    log(f"(f) large stream: K2 == plain on its {len(k2_reps)} buckets")
    # The segmented path hands this stream to the host walk whole (past
    # the byte limit, and more than 2 channels, as the JAX package does),
    # so the fused front is held to its plain form on its whole upload as
    # one 8-channel group, and K7 on its frames directly: the source
    # frames' front as one 8-channel group.
    i32 = dict(dtype=torch.int32, device=DEVICE)
    for label, raw in (("large stream's upload", data), ("large stream's "
                       "frames", large_source()[0])):
        words_le = torch.from_numpy(np.frombuffer(
            raw + bytes(-len(raw) % 4), "<i4").copy()).to(DEVICE)
        args = (words_le, len(raw), torch.full((8,), len(raw), **i32),
                torch.full((8,), 24, **i32), 4096, 8,
                seg_parse.pick_cap(len(raw)),
                64 if raw is not data else seg_parse.pick_wcap(len(raw)))
        rf = compare(f"front {label}", lambda: seg_parse.demux_front(*args),
                     lambda: seg_parse.demux_front_plain(*args), 1)
        stream, _p, _v, count, _w, _f, _l, walk_in, counts = \
            seg_parse.demux_front(*args)
        log(f"(f) {label}: W={words_le.shape[0]} cap={args[6]} "
            f"wcap={args[7]}, {int(count)} sync hits, {int(counts[1])} "
            f"walkable: the fused front == plain, every output "
            f"({rf[1]:.3f} ms vs {rf[2]:.1f} ms)")
    cap, wcap = args[6], args[7]
    n = int(counts[1])  # the frames, and any sync mimic that parses
    if int(count) > cap or not LARGE_SOURCE_FRAMES <= n <= wcap:
        raise AssertionError(f"large stream's frames: {int(count)} sync "
                             f"hits (cap {cap}), {n} walked (wcap {wcap})")
    r7 = compare("K7 large stream's frames",
                 lambda: demux.walk_frames(stream, *walk_in, 4096, 8),
                 lambda: demux.walk_frames_plain(stream, *walk_in, 4096, 8))
    ok = demux.walk_frames(stream, *walk_in, 4096, 8)[2]
    log(f"(f) large stream's {LARGE_SOURCE_FRAMES} distinct frames as one "
        f"8-channel group, T=4096, {n} walk lanes: K7 == plain ({r7[1]:.3f} "
        f"ms vs {r7[2]:.1f} ms); {int(ok.sum())} accepted by the walk")
    return k2_reps


def phase_g(base, wide):
    """Containers at full width: each headline stream, and the 24-bit
    ``wide`` stream, from Ogg and from MP4 on the card. Returns the launch
    counts of the first Ogg decode."""
    import numpy as np

    import claxon_tpu_torch as ct
    from claxon_tpu_torch import native
    from claxon_tpu_torch.ops import (crc, entropy, epilogue, predict)
    from claxon_tpu_torch.testing import (mux_mp4_flac, mux_ogg_flac,
                                          pcm_md5)

    wrappers = {"K1+K3": predict.synthesize_epilogue,
                "K1": predict.synthesize,
                "K2": entropy.decode_residual_bits_stream,
                "K4": crc.crc16_ranges,
                "K3b_pack": epilogue.pack_int16_pairs,
                "K3b_unpack": epilogue.unpack_int16_pairs}
    first = None
    for i, flac in enumerate(list(base) + [wide]):
        si, want = native.decode_stream_scalar(flac)
        t0 = time.perf_counter()
        ogg, mp4 = mux_ogg_flac(flac), mux_mp4_flac(flac, frames_per_chunk=3)
        mux_s = time.perf_counter() - t0
        times = {}
        for name, fn, data in (("Ogg", ct.decode_ogg_stream, ogg),
                               ("MP4", ct.decode_mp4_stream, mp4)):
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            dec = fn(data, device=DEVICE)
            times[name] = (time.perf_counter() - t0) * 1e3
            counts = {k: w.launches for k, w in wrappers.items()}
            if not np.array_equal(dec.pcm, want):
                raise AssertionError(f"(g) stream {i} from {name}: PCM != "
                                     "scalar decoder")
            if pcm_md5(dec.pcm, si.bits_per_sample) != si.md5sum:
                raise AssertionError(f"(g) stream {i} from {name}: MD5 "
                                     "mismatch")
            packs = si.bits_per_sample <= 16
            if (counts["K3b_pack"] > 0) != packs or counts["K1"] or not all(
                    counts[k] > 0
                    for k in ("K1+K3", "K2", "K4", "K3b_unpack")):
                raise AssertionError(f"(g) stream {i} from {name}: "
                                     f"launches {counts}")
            if first is None:
                first = counts
        # The Ogg time includes the page CRC-32s, checked in Python.
        raw = ct.decode_ogg_stream(ogg, verify_crc=False, device=DEVICE)
        t0 = time.perf_counter()
        raw = ct.decode_ogg_stream(ogg, verify_crc=False, device=DEVICE)
        nocrc_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(raw.pcm, want):
            raise AssertionError(f"(g) stream {i} from Ogg without page "
                                 "CRCs: PCM != scalar decoder")
        log(f"(g) stream {i} ({si.bits_per_sample}-bit, {len(flac)} bytes, "
            f"{want.shape[0]} samples x {want.shape[1]}): Ogg "
            f"{times['Ogg']:.1f} ms ({nocrc_ms:.1f} ms without the page "
            f"CRCs), MP4 {times['MP4']:.1f} ms, bit-exact with MD5; "
            f"{'packed' if si.bits_per_sample <= 16 else 'not packed'}; "
            f"muxed in {mux_s:.1f} s")
    # Malformed containers raise the reference's errors.
    ogg = bytearray(mux_ogg_flac(base[0]))
    ogg[len(ogg) // 2] ^= 0xFF
    mp4 = mux_mp4_flac(base[0], frames_per_chunk=3)
    at = mp4.index(b"stsc") + 4 + 12  # the first entry's frames per chunk
    mp4 = mp4[:at] + (4).to_bytes(4, "big") + mp4[at + 4:]
    for name, fn, data, msg in (
            ("Ogg page CRC", ct.decode_ogg_stream, bytes(ogg),
             "Ogg page CRC mismatch"),
            ("short MP4 chunk", ct.decode_mp4_stream, mp4,
             "MP4 chunk ends before its declared frame count")):
        try:
            fn(data, device=DEVICE)
        except ct.FormatError as e:
            if msg not in str(e):
                raise
            log(f"(g) {name}: refused: {e}")
        else:
            raise AssertionError(f"(g) {name}: a malformed container "
                                 "decoded")
    # use_native=False: the Python extractor and the FrameDesc route, on
    # the 24-bit stream and the first headline one (about 3 us a sample on
    # the host, so not every stream).
    for i, flac in ((len(base), wide), (0, base[0])):
        for name, fn, data in (
                ("Ogg", ct.decode_ogg_stream, mux_ogg_flac(flac)),
                ("MP4", ct.decode_mp4_stream,
                 mux_mp4_flac(flac, frames_per_chunk=3))):
            t0 = time.perf_counter()
            got = fn(data, use_native=False, device=DEVICE)
            ms = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(got.pcm, fn(data, device=DEVICE).pcm):
                raise AssertionError(f"(g) stream {i} from {name}, "
                                     "use_native=False: PCM != the default "
                                     "route's")
            log(f"(g) stream {i} from {name}, use_native=False (Python "
                f"extractor, FrameDesc route): PCM == the default route's, "
                f"{ms:.1f} ms")
    return first


def windows(fn):
    """Host milliseconds of ``fn()`` over ``TIMED_RUNS`` windows, each
    begun on an idle card: (median, least, most)."""
    import torch

    ts = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts), max(ts)


def framedesc_packing(datas):
    """(buckets, buckets whose residuals go up as int16 pairs, buckets
    fetched as int16 pairs) of the FrameDesc route on ``datas``, from the
    C++ extractor's FrameDescs (equal to the Python extractor's; tier-1
    holds them so) and the JAX package's packing rule, in numpy alone."""
    from claxon_tpu_torch import native
    from claxon_tpu_torch import pipeline as tp

    frames = [f for d in datas for f in native.extract_stream(d).frames]
    n = unpacks = packs = 0
    for (t_bucket, n_ch), idx in tp.group_frames(frames).items():
        x = tp.pack_bucket(frames, idx, n_ch, t_bucket)[0]
        even = x.shape[1] % 2 == 0
        n += 1
        unpacks += even and -32768 <= x.min() and x.max() <= 32767
        packs += even and all(frames[i].bps <= 16 for i in idx)
    return n, unpacks, packs


def phase_h(drive, datas4, mixed, generated):
    """The FrameDesc route (use_native=False, and decode_bucket): (h1)
    decode_streams(mixed + generated, False) through the Python extractor;
    (h2) decode_batches_device on the C++ extractor's FrameDescs of
    headline x4, one bucket, K1 + K3 held to its plain form and timed there;
    (h3) the decode_bucket override on two headline streams; (h4)
    FlacReader on the generated corpus on both reader routes. Returns
    (h2)'s K1 + K3 row and bound, its launches and the (h1)/(h2) numbers
    for the JSON line."""
    import functools

    import numpy as np
    import torch

    import claxon_tpu_torch as ct
    from claxon_tpu_torch import native
    from claxon_tpu_torch import pipeline as tp
    from claxon_tpu_torch.ops import epilogue, predict
    from claxon_tpu_torch.testing import pcm_md5

    absent = ("K2", "K4", "K5", "K6", "K7", "K8", "K9", "K10")
    out = {}

    def fetched(dd):
        dd.to_host()
        return dd

    # (h1) the Python extractor, mixed and generated corpora.
    datas = mixed + generated
    n, unpacks, packs = framedesc_packing(datas)
    t0 = time.perf_counter()
    res, counts = drive(("K1+K3",), lambda: ct.decode_streams(
        datas, False, device=DEVICE))
    h1_ms = (time.perf_counter() - t0) * 1e3
    check_decoded("(h1) mixed + generated, use_native=False", datas, res)
    want = {"K1+K3": n, "K3b_unpack": unpacks, "K3b_pack": packs}
    if any(counts[k] for k in absent) or any(
            counts[k] != v for k, v in want.items()):
        raise AssertionError(f"(h1) launches {counts}, expected {want} and "
                             f"none of {absent}")
    log(f"(h1) decode_streams(mixed + generated, False): {len(datas)} "
        f"streams, {n} buckets ({unpacks} uploaded as int16 pairs, {packs} "
        f"fetched as int16 pairs) in {h1_ms:.1f} ms (Python extractor "
        f"included); launches {counts}")
    out["h1"] = {"streams": len(datas), "buckets": n, "launches": counts,
                 "ms": h1_ms}

    # (h2) the FrameDesc dispatch at full width, fed by the C++ extractor.
    batches = [native.extract_stream(d) for d in datas4]
    dd, counts = drive(("K1+K3", "K3b_unpack", "K3b_pack"), lambda: fetched(
        tp.decode_batches_device(batches, device=DEVICE)))
    # One bucket: at the full size (6912, 4096).
    shape = tp.bucket_shape(2 * len(dd.frames), 4096)
    if [tuple(d.out_full.shape) for d in dd.dispatches] != [shape] \
            or [counts[k] for k in ("K1+K3", "K3b_unpack", "K3b_pack")] \
            != [1, 1, 1] or any(counts[k] for k in absent):
        raise AssertionError(f"(h2) buckets {len(dd.dispatches)} of "
                             f"{dd.dispatches[0].out_full.shape}, launches "
                             f"{counts}")
    check_decoded(f"(h2) headline x{HEADLINE_REPLICAS}, FrameDesc dispatch",
                  datas4, dd.results)
    h2_pcm = [r.pcm for r in dd.results]
    (d,) = dd.dispatches
    x, coefs, shifts, orders, wasted, pair_modes, lengths = (
        torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
        for a in tp.pack_bucket(dd.frames, d.frame_idx, 2, 4096))
    args = (x, coefs, shifts, orders, lengths, wasted, pair_modes)
    row = compare("K1+K3 FrameDesc headline",
                  lambda: predict.synthesize_epilogue(*args),
                  lambda: predict.synthesize_epilogue_plain(*args))
    if not torch.equal(predict.synthesize_epilogue(*args), d.out_full):
        raise AssertionError("(h2) K1+K3 on the re-packed bucket != the "
                             "dispatch's output")
    b = bound(tensor_bytes(*args) + tensor_bytes(d.out_full),
              synth_ops(orders, lengths))
    upload = dd.upload_bytes
    del dd, d, x, args

    extract = windows(lambda: [native.extract_stream(d) for d in datas4])
    resident = windows(lambda: tp.decode_batches_device(
        batches, device=DEVICE).sync())
    host = windows(lambda: tp.decode_batches_device(
        batches, device=DEVICE).to_host())
    log(f"(h2) headline x{HEADLINE_REPLICAS} through the FrameDesc dispatch "
        f"(L {shape[0]}, T {shape[1]}): K1+K3 {row[1]:.4f} ms (plain "
        f"{row[2]:.1f} ms), bound {b[0]:.4f} ms ({b[1]}); {upload} bytes uploaded; host ms, "
        f"median of {TIMED_RUNS} (min-max): C++ FrameDesc extraction "
        f"{extract[0]:.1f} ({extract[1]:.1f}-{extract[2]:.1f}), dispatch "
        f"device-resident {resident[0]:.1f} ({resident[1]:.1f}-"
        f"{resident[2]:.1f}), to host {host[0]:.1f} ({host[1]:.1f}-"
        f"{host[2]:.1f}); launches {counts}")
    out["h2"] = {"shape": shape, "upload_bytes": upload,
                 "extract_ms": extract, "device_resident_ms": resident,
                 "to_host_ms": host}

    # (h3) decode_bucket: the per-bucket device call, on the C++
    # extractor's FrameDescs of two headline streams.
    bucket = functools.partial(tp.device_decode_bucket, device=DEVICE)
    res, counts3 = drive(("K1+K3",), lambda: ct.decode_streams(
        datas4[:2], True, bucket))
    if any(not np.array_equal(r.pcm, w) for r, w in zip(res, h2_pcm)):
        raise AssertionError("(h3) decode_bucket PCM != (h2)'s")
    log(f"(h3) decode_streams(headline[:2], True, device_decode_bucket): "
        f"PCM == (h2)'s; launches {counts3}")

    # (h4) the reader API on the generated corpus, both reader routes.
    for knob in (None, "1"):
        if knob:
            os.environ["CLAXON_TPU_NO_NATIVE_READER"] = knob
        try:
            t0 = time.perf_counter()
            for data in generated:
                r = ct.FlacReader(data)
                si = r.streaminfo()
                pcm = np.array(list(r.samples()), dtype=np.int64).reshape(
                    -1, si.channels)
                if si.md5sum != b"\x00" * 16 and \
                        pcm_md5(pcm, si.bits_per_sample) != si.md5sum:
                    raise AssertionError(f"(h4) FlacReader MD5 mismatch "
                                         f"(native reader off: {knob})")
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            os.environ.pop("CLAXON_TPU_NO_NATIVE_READER", None)
        log(f"(h4) FlacReader samples() on {len(generated)} generated "
            f"streams, {'Python' if knob else 'native'} reader route: MD5 "
            f"== STREAMINFO, {ms:.1f} ms")
    return row, b, counts, out


#: The JAX package's other entropy routes: (variable, value,
#: segmentation, the kernels the headline decode must launch).
ENTROPY_ROUTES = (("CLAXON_TPU_ENTROPY", "delta", "host",
                   ("K9", "K1+K3", "K3b_pack")),
                  ("CLAXON_TPU_SEG_ENTROPY", "delta", "device",
                   ("K5", "K6", "K7", "K10", "K1+K3", "K4", "K3b_pack")),
                  ("CLAXON_TPU_SEG_ENTROPY", "scan", "device",
                   ("K5", "K6", "K7", "K2", "K1+K3", "K4", "K3b_pack")))


def phase_i(drive, datas4, mixed, generated, base, host_launches,
            seg_launches, routes):
    """(i) The sharded route (``claxon_tpu_torch.parallel``) on the card:
    ``make_mesh()`` (every card: one here) and a mesh of two shards on the
    one card. Each decodes headline x4 through ``decode_streams_sharded``
    on the host walk and the segmented path, launches counted (each
    per-lane kernel once a shard per bucket or dispatch, the group kernels
    once a group: the unsharded counts of (c), ``host_launches`` and
    ``seg_launches``, times the shards), then mixed and generated with
    segmentation "host", "device" and None ("auto", the cached choice
    reset), and mixed with use_native=False; the two-shard mesh also
    decodes headline x4 and mixed on each of ``ENTROPY_ROUTES``, launches
    counted against (c)'s unsharded ``routes``; every PCM is held to the
    unsharded decode, the scalar decoder and the MD5. K2 and K1 + K3 are
    held to their plain forms on each shard of the headline bucket, and
    K4 on each shard's half of its CRC ranges, and timed; the overflow stream goes through the two-shard mesh (the
    per-lane flag of its shard fires, that shard comes back as int32);
    the device-resident decodes of headline x4 are timed on both meshes
    (median of 5, with the range). Returns the two-shard launches and the
    numbers for the JSON line."""
    import numpy as np
    import torch

    import claxon_tpu_torch as ct
    from claxon_tpu_torch import native
    from claxon_tpu_torch import pipeline as tp
    from claxon_tpu_torch import pipeline_seg as ps
    from claxon_tpu_torch.ops import crc, entropy, predict
    from claxon_tpu_torch.parallel import (decode_streams_sharded,
                                           lane_quantum, make_mesh)
    from claxon_tpu_torch.pipeline_bits import (inputs_from_numpy,
                                                plan_raw_bits, unpack_mb)

    per_lane = ("K1+K3", "K2", "K4", "K8", "K9", "K10", "K3b_pack",
                "K3b_unpack")
    group = ("K5", "K6", "K7")
    meshes = {"one": make_mesh(),
              "two": make_mesh(devices=[f"{DEVICE}:0"] * 2)}
    if meshes["one"].size != 1 or meshes["two"].size != 2:
        raise AssertionError(f"(i) meshes of {meshes['one'].size} and "
                             f"{meshes['two'].size} devices")
    out = {"launches": {}, "auto": {}}
    os.environ.pop("CLAXON_TPU_SEGMENTATION", None)

    def unsharded(datas, segmentation):
        return [r.pcm for r in ct.decode_streams_device(
            datas, segmentation=segmentation, device=DEVICE).to_host()]

    def held(label, datas, res, want):
        check_decoded(f"(i) {label}", datas, res)
        if any(not np.array_equal(r.pcm, w) for r, w in zip(res, want)):
            raise AssertionError(f"(i) {label}: PCM != the unsharded "
                                 "decode's")

    want4 = unsharded(datas4, "host")
    for name, mesh in meshes.items():
        n = mesh.size
        for path, ref, kernels in (
                ("host", host_launches, ("K1+K3", "K2", "K4", "K3b_pack")),
                ("device", seg_launches,
                 ("K1+K3", "K4", "K5", "K6", "K7", "K8", "K3b_pack"))):
            res, counts = drive(kernels, lambda: decode_streams_sharded(
                datas4, mesh, segmentation=path))
            held(f"headline x{HEADLINE_REPLICAS}, {path}, {name} shard(s)",
                 datas4, res, want4)
            want = {k: ref[k] * (n if k in per_lane else 1)
                    for k in per_lane + group}
            if {k: counts[k] for k in want} != want:
                raise AssertionError(f"(i) {path}, {n} shard(s): launches "
                                     f"{counts}, expected {want}")
            out["launches"][f"{path}_{name}"] = counts
            log(f"(i) headline x{HEADLINE_REPLICAS}, {path}, {n} shard(s) "
                f"({mesh.devices}): bit-exact; launches {counts}")
        for label, datas in (("mixed", mixed), ("generated", generated)):
            for segmentation in ("host", "device", None):
                if segmentation is None:
                    tp._SEG_AUTO.clear()
                want = unsharded(datas, segmentation or "host")
                res = decode_streams_sharded(datas, mesh,
                                             segmentation=segmentation)
                tag = segmentation or "auto (chose " + str(
                    tp._seg_auto(mesh.devices[0])["choice"]) + ")"
                held(f"{label}, {tag}, {name} shard(s)", datas, res, want)
                if segmentation is None:
                    out["auto"][f"{label}_{name}"] = tp._seg_auto(
                        mesh.devices[0])["choice"]
        res = decode_streams_sharded(mixed, mesh, use_native=False)
        held(f"mixed, use_native=False, {name} shard(s)", mixed, res,
             unsharded(mixed, "host"))

    # The other entropy routes over two shards: each per-lane kernel
    # (K9, K10, K2 among them) once a shard where (c)'s unsharded decode
    # of the route launched it once, the group kernels once a group.
    two = meshes["two"]
    for var, value, path, kernels in ENTROPY_ROUTES:
        route = f"{var}={value}"
        ref = routes[route]["launches"]
        os.environ[var] = value
        try:
            res, counts = drive(kernels, lambda: decode_streams_sharded(
                datas4, two, segmentation=path))
            held(f"headline x{HEADLINE_REPLICAS}, {route}, two shard(s)",
                 datas4, res, want4)
            held(f"mixed, {route}, two shard(s)", mixed,
                 decode_streams_sharded(mixed, two, segmentation=path),
                 unsharded(mixed, path))
        finally:
            del os.environ[var]
        want = {k: ref[k] * (two.size if k in per_lane else 1)
                for k in per_lane + group + ("K7_with_deltas",)}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"(i) {route}, two shards: launches "
                                 f"{counts}, expected {want}")
        out["launches"][f"{route}_two"] = counts
        log(f"(i) headline x{HEADLINE_REPLICAS}, {route}, two shards: "
            f"bit-exact; launches {counts}")

    # K2 and K1 + K3 on each shard of the headline bucket, against their
    # plain forms and timed; their sums beside the whole bucket's.
    bp = plan_raw_bits(tp.extract_streams_bits(datas4, native),
                       lane_quantum(two), "stream", two.size)
    (b,) = bp.bits
    stream, _mb, _se = inputs_from_numpy(bp.stream, None, None, DEVICE)
    shard_rows = []
    for lo, hi in ((0, len(b.mb)), (0, len(b.mb) // 2),
                   (len(b.mb) // 2, len(b.mb))):
        mb = inputs_from_numpy(b.mb[lo:hi], device=DEVICE)[0]
        u = unpack_mb(mb, b.n_parts_max, b.nc)
        k2_args = (stream, u["bases"], u["ks"], u["ps"], u["orders"],
                   u["pbits"], u["flags"], u["warm"], u["lengths"])
        kw = dict(n_parts_max=b.n_parts_max, sa=b.sa)
        tag = f"lanes {lo}-{hi}"
        r2 = compare(f"(i) K2 {tag}", lambda: entropy.
                     decode_residual_bits_stream(*k2_args, **kw),
                     lambda: entropy.decode_residual_bits_stream_plain(
                         *k2_args, **kw))
        x = entropy.decode_residual_bits_stream(*k2_args, **kw)
        k13_args = (x, u["coefs"], u["shifts"], u["orders"], u["lengths"],
                    u["wasted"], u["pair_modes"])
        r13 = compare(f"(i) K1+K3 {tag}",
                      lambda: predict.synthesize_epilogue(*k13_args),
                      lambda: predict.synthesize_epilogue_plain(*k13_args))
        shard_rows.append({"lanes": [lo, hi], "K2_ms": r2[1],
                           "K2_plain_ms": r2[2], "K1+K3_ms": r13[1],
                           "K1+K3_plain_ms": r13[2]})
        log(f"(i) {tag} of the headline bucket (T {b.nc * 32}): K2 == plain "
            f"{r2[1]:.4f} ms (plain {r2[2]:.1f}), K1+K3 == plain "
            f"{r13[1]:.4f} ms (plain {r13[2]:.1f})")
    # K4 on each shard's half of the batch's CRC ranges.
    F = bp.se.shape[1]
    for row, (lo, hi) in zip(shard_rows, ((0, F), (0, F // 2),
                                          (F // 2, F))):
        se = inputs_from_numpy(bp.se[:, lo:hi], device=DEVICE)[0]
        starts, ends = se[0].contiguous(), se[1].contiguous()
        r4 = compare(f"(i) K4 ranges {lo}-{hi}",
                     lambda: crc.crc16_ranges(stream, starts, ends),
                     lambda: crc.crc16_ranges_plain(stream, starts, ends))
        row.update(K4_ranges=[lo, hi], K4_ms=r4[1], K4_plain_ms=r4[2])
        log(f"(i) K4 on ranges {lo}-{hi} of {F}: == plain {r4[1]:.4f} ms "
            f"(plain {r4[2]:.1f})")
    out["shard_kernels"] = shard_rows
    for k in ("K2_ms", "K1+K3_ms", "K4_ms"):
        total = sum(r[k] for r in shard_rows[1:])
        log(f"(i) {k[:-3]}: the two shards {total:.4f} ms against the "
            f"whole bucket's {shard_rows[0][k]:.4f} ms")

    # The overflow stream behind a headline stream: 222 lanes, one bucket
    # of 256 split at lane 128, the damaged frame in the second shard.
    loud = overflow_stream()
    pair = [base[0], loud]
    for path in ("host", "device"):
        if path == "host":
            dd = tp._decode_host_walk(pair, lane_quantum(two), two.devices[0],
                                      mesh=two)
        else:
            dd = ps.decode_streams_segmented(pair, mesh=two)
        res = dd.to_host()
        check_decoded(f"(i) overflow stream's neighbour, {path}", pair[:1],
                      res[:1])
        if not np.array_equal(res[1].pcm, native.decode_stream_scalar(
                loud)[1]):
            raise AssertionError(f"(i) overflow stream, {path}: PCM != "
                                 "scalar decoder")
        leaves = [(int(s.flag.sum()), s.host is not None)
                  for d in dd.dispatches for s in d.shards]
        if [refetched for _f, refetched in leaves] != \
                [flagged > 0 for flagged, _r in leaves] or \
                sum(refetched for _f, refetched in leaves) != 1:
            raise AssertionError(f"(i) overflow stream, {path}: shard flags "
                                 f"and refetches {leaves}")
        out[f"overflow_{path}"] = leaves
        log(f"(i) overflow stream through two shards, {path}: per shard "
            f"(lanes flagged, refetched as int32) {leaves}; PCM == scalar "
            "decoder")

    # Device-resident headline x4 on both meshes, in turns.
    runs = {}
    for path in ("host", "device"):
        def decode(mesh):
            if path == "host":
                return tp._decode_host_walk(datas4, lane_quantum(mesh),
                                            mesh.devices[0], mesh=mesh)
            return ps.decode_streams_segmented(datas4, mesh=mesh)

        for name in ("one", "two", "two", "one") * 3:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(meshes[name]).sync()
            runs.setdefault(f"{path}_{name}", []).append(
                (time.perf_counter() - t0) * 1e3)
    out["device_resident_ms"] = {}
    for key, ts in runs.items():
        ts = ts[1:]  # the first run of each is a warm-up
        med = statistics.median(ts)
        out["device_resident_ms"][key] = {"median": med, "min": min(ts),
                                          "max": max(ts), "runs": ts}
        log(f"(i) headline x{HEADLINE_REPLICAS} device-resident, {key}: "
            f"{med:.1f} ms (median of {len(ts)}, {min(ts):.1f}-"
            f"{max(ts):.1f})")
    return out["launches"]["host_two"], out["launches"]["device_two"], out


def phase_j(drive, datas4, mixed, generated, base):
    """(j) The sample-shipping route, ``CLAXON_TPU_NO_BITS=1`` (set only
    around this phase): (j1) headline x4 through decode_streams_device is
    one raw bucket (6912, 4096) uploaded as int16 pairs, one launch each
    of K3b unpack, K1 + K3 and K3b pack per batch to host and none of K2,
    K4, K5-K10; K3b unpack and K1 + K3 held to their plain forms on its
    upload and timed; the C++ raw extraction, the dispatch and the two
    through decode_streams_device in one window timed (median of 5, with
    the range); (j2) mixed + generated through
    decode_streams, each kernel's launches as the FrameDesc route's
    packing rule predicts (the same buckets); (j3) one headline stream
    from Ogg and from MP4 (the C++ FrameDescs through K3b unpack and K1 +
    K3); (j4) decode_streams_sharded over two shards of the card (the
    FrameDesc step, each per-lane kernel once a shard) and the raw route
    over the same mesh. Every PCM is held to the scalar decoder and the
    MD5. Returns the numbers for the JSON line."""
    import numpy as np
    import torch

    import claxon_tpu_torch as ct
    from claxon_tpu_torch import native
    from claxon_tpu_torch import pipeline as tp
    from claxon_tpu_torch import pipeline_bits as pb
    from claxon_tpu_torch.ops import epilogue, predict
    from claxon_tpu_torch.parallel import (decode_streams_sharded,
                                           lane_quantum, make_mesh)
    from claxon_tpu_torch.testing import mux_mp4_flac, mux_ogg_flac

    absent = ("K2", "K4", "K5", "K6", "K7", "K8", "K9", "K10")
    out = {"launches": {}}
    uploads = []
    shards = pb._decode_sample_shards

    def recorded(arrays, in_packed, mesh):
        uploads.append((arrays, in_packed))
        return shards(arrays, in_packed, mesh)

    def expect(label, counts, want):
        if any(counts[k] for k in absent) or any(
                counts[k] != v for k, v in want.items()):
            raise AssertionError(f"(j) {label}: launches {counts}, expected "
                                 f"{want} and none of {absent}")
        out["launches"][label] = counts
        log(f"(j) {label}: launches {counts}")

    def fetched(dd):
        dd.to_host()
        return dd

    auto = dict(tp._seg_auto(DEVICE))
    os.environ["CLAXON_TPU_NO_BITS"] = "1"
    pb._decode_sample_shards = recorded
    try:
        # (j1) headline x4: one raw bucket.
        dd, counts = drive(("K1+K3", "K3b_unpack", "K3b_pack"),
                           lambda: fetched(ct.decode_streams_device(
                               datas4, device=DEVICE)))
        check_decoded(f"(j1) headline x{HEADLINE_REPLICAS}, "
                      "CLAXON_TPU_NO_BITS", datas4, dd.results)
        expect(f"headline x{HEADLINE_REPLICAS}", counts,
               {"K1+K3": 1, "K3b_unpack": 1, "K3b_pack": 1})
        (d,) = dd.dispatches
        ((arrays, in_packed),) = uploads
        shape = tuple(d.out_full.shape)
        # At the full size (6912, 4096).
        want = tp.bucket_shape(2 * sum(len(r.frame_sizes)
                                       for r in dd.results), 4096)
        if shape != want or not (in_packed and d.packed):
            raise AssertionError(f"(j1) bucket {shape}, packed in/out "
                                 f"{in_packed}/{d.packed}")
        runs = sum(len(p) for p in dd.lane_plans())
        x16, coefs, shifts, orders, wasted, pair_modes, lengths = (
            torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
            for a in arrays)
        ru = compare("(j1) K3b unpack raw headline",
                     lambda: epilogue.unpack_int16_pairs(x16),
                     lambda: epilogue.unpack_int16_pairs_plain(x16))
        x = epilogue.unpack_int16_pairs(x16)
        args = (x, coefs, shifts, orders, lengths, wasted, pair_modes)
        r13 = compare("(j1) K1+K3 raw headline",
                      lambda: predict.synthesize_epilogue(*args),
                      lambda: predict.synthesize_epilogue_plain(*args))
        if not torch.equal(predict.synthesize_epilogue(*args), d.out_full):
            raise AssertionError("(j1) K1+K3 on the recorded upload != the "
                                 "dispatch's output")
        bu = bound(tensor_bytes(x16, x))
        b13 = bound(tensor_bytes(*args) + tensor_bytes(d.out_full),
                    synth_ops(orders, lengths))
        upload = dd.upload_bytes
        del dd, d, x, x16, args

        pb._decode_sample_shards = shards
        raws = [native.extract_stream_raw(d) for d in datas4]
        extract = windows(lambda: [native.extract_stream_raw(d)
                                   for d in datas4])
        resident = windows(lambda: tp.decode_raw_batches_device(
            raws, device=DEVICE).sync())
        host = windows(lambda: tp.decode_raw_batches_device(
            raws, device=DEVICE).to_host())
        del raws
        # Extraction and dispatch in one window, through the entry point.
        whole = windows(lambda: ct.decode_streams_device(
            datas4, device=DEVICE).sync())
        log(f"(j1) headline x{HEADLINE_REPLICAS} through the raw route (L "
            f"{shape[0]}, T {shape[1]}, {runs} lane runs, {upload} bytes "
            f"uploaded): K3b unpack == plain {ru[1]:.4f} ms (plain "
            f"{ru[2]:.1f} ms), bound {bu[0]:.4f} ms ({bu[1]}); K1+K3 == "
            f"plain {r13[1]:.4f} ms (plain {r13[2]:.1f} ms), bound "
            f"{b13[0]:.4f} ms ({b13[1]}); host ms, median of {TIMED_RUNS} "
            f"(min-max): C++ raw extraction {extract[0]:.1f} ({extract[1]:.1f}"
            f"-{extract[2]:.1f}), dispatch device-resident {resident[0]:.1f} "
            f"({resident[1]:.1f}-{resident[2]:.1f}), to host {host[0]:.1f} "
            f"({host[1]:.1f}-{host[2]:.1f}); decode_streams_device "
            f"device-resident, extraction included, {whole[0]:.1f} "
            f"({whole[1]:.1f}-{whole[2]:.1f})")
        out.update(shape=shape, lane_runs=runs, upload_bytes=upload,
                   k3b_unpack={"ms": ru[1], "plain_ms": ru[2],
                               "max_abs_err": ru[0], "bound_ms": bu[0]},
                   k1_k3={"ms": r13[1], "plain_ms": r13[2],
                          "max_abs_err": r13[0], "bound_ms": b13[0]},
                   extract_ms=extract, device_resident_ms=resident,
                   to_host_ms=host, end_to_end_resident_ms=whole)

        # (j2) mixed + generated: the FrameDesc route's buckets and rule.
        datas = mixed + generated
        n, unpacks, packs = framedesc_packing(datas)
        res, counts = drive(("K1+K3",), lambda: ct.decode_streams(
            datas, device=DEVICE))
        check_decoded("(j2) mixed + generated, CLAXON_TPU_NO_BITS", datas,
                      res)
        expect("mixed + generated", counts,
               {"K1+K3": n, "K3b_unpack": unpacks, "K3b_pack": packs})

        # (j3) the containers: the C++ FrameDescs, the FrameDesc route.
        for fmt, fn, mux in (("ogg", ct.decode_ogg_stream, mux_ogg_flac),
                             ("mp4", ct.decode_mp4_stream,
                              functools.partial(mux_mp4_flac,
                                                frames_per_chunk=3))):
            data = mux(base[0])
            res, counts = drive(("K1+K3", "K3b_unpack"), lambda: fn(
                data, device=DEVICE))
            check_decoded(f"(j3) headline[0] from {fmt}, CLAXON_TPU_NO_BITS",
                          base[:1], [res])
            expect(f"{fmt} headline[0]", counts,
                   {"K1+K3": 1, "K3b_unpack": 1, "K3b_pack": 1})

        # (j4) two shards of the card: the sharded call's FrameDesc step
        # (its shards come back as int32, no K3b pack), and the raw route.
        two = make_mesh(devices=[f"{DEVICE}:0"] * 2)
        res, counts = drive(("K1+K3", "K3b_unpack"),
                            lambda: decode_streams_sharded(datas4, two))
        check_decoded(f"(j4) headline x{HEADLINE_REPLICAS}, "
                      "decode_streams_sharded, two shards", datas4, res)
        expect("decode_streams_sharded, two shards", counts,
               {"K1+K3": 2, "K3b_unpack": 2, "K3b_pack": 0})
        dd, counts = drive(("K1+K3", "K3b_unpack", "K3b_pack"),
                           lambda: fetched(ct.decode_streams_device(
                               datas4, lane_quantum=lane_quantum(two),
                               device=two.devices[0], mesh=two)))
        check_decoded(f"(j4) headline x{HEADLINE_REPLICAS}, raw route, two "
                      "shards", datas4, dd.results)
        expect("raw route, two shards", counts,
               {"K1+K3": 2, "K3b_unpack": 2, "K3b_pack": 2})
    finally:
        pb._decode_sample_shards = shards
        del os.environ["CLAXON_TPU_NO_BITS"]
    if tp._seg_auto(DEVICE) != auto:
        raise AssertionError(f"(j) the route changed the cached auto "
                             f"choice: {auto} -> {tp._seg_auto(DEVICE)}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs on a CUDA card", file=sys.stderr)
        return 2

    import numpy as np

    import claxon_tpu_torch as ct
    from claxon_tpu_torch import native, trace
    from claxon_tpu_torch.ops import (_build, crc, demux, entropy, epilogue,
                                      predict, rice, seg_gather, seg_parse,
                                      segment)
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import plan_raw_bits

    for name in sys.modules:
        if name.split(".")[0] in ("jax", "jaxlib", "claxon_tpu"):
            raise AssertionError(f"the port imported {name}")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"(a) card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    _build.load()
    log(f"(a) kernels built and loaded in "
        f"{trace.process.seconds('claxon.build'):.1f} s")
    if not native.available():
        raise AssertionError("the C++ host core did not build")

    t0 = time.perf_counter()
    base = headline_corpus()
    datas4 = base * HEADLINE_REPLICAS
    mixed = mixed_corpus()
    gen_paths = sorted((REPO / "testsamples" / "generated").glob("*.flac"))
    generated = [p.read_bytes() for p in gen_paths]
    generated_names = [p.name for p in gen_paths]
    log(f"(a) corpora encoded in {time.perf_counter() - t0:.1f} s: "
        f"headline x{HEADLINE_REPLICAS} = {len(datas4)} streams "
        f"({sum(map(len, datas4))} bytes), mixed {len(mixed)}, generated "
        f"{len(generated)}")

    t_start = time.perf_counter()
    rows, bounds, library, main_shape, k4_shape = phase_b(datas4, mixed,
                                                          generated)
    fallback = fallback_corpus()
    phase_b_fallback(fallback)
    phase_b_pack16()
    seg_rows, seg_bounds = phase_b_seg(datas4, mixed)
    phase_b_front(base[0], fallback)
    rows.update(seg_rows)
    bounds.update(seg_bounds)
    t_routes = time.perf_counter()
    route_rows, route_bounds = phase_b_routes(datas4, mixed)
    log(f"(b) the entropy routes' kernels took "
        f"{time.perf_counter() - t_routes:.1f} s")
    rows.update(route_rows)
    bounds.update(route_bounds)
    t_rc = time.perf_counter()
    rc_rows, rc_bounds = phase_b_rice_crc(datas4, rows["main_dims"])
    log(f"(b) rice_decode, crc16_device and crc16_frames_device took "
        f"{time.perf_counter() - t_rc:.1f} s")
    rows.update(rc_rows)
    bounds.update(rc_bounds)

    # (c) each path, through the public calls.
    # The fused front does K5's work and K6's bswap, fields and compaction
    # in two kernels: it counts under both. The parent's wrappers of
    # those pieces run on no path.
    # No decode route calls these three: they run 0 times on every path.
    test_only = {"rice_decode": rice.rice_decode,
                 "crc16_device": crc.crc16_device,
                 "crc16_frames_device": crc.crc16_frames_device}
    seg_wrappers = {
        "K5": [seg_parse.demux_front],
        "K6": [seg_parse.demux_front, seg_parse.pack_summary],
        "K7": [demux.walk_frames], "K8": [seg_gather.gather_values],
        "K5_K6_parent": [segment.find_frame_headers, seg_parse.bswap_words,
                         seg_parse.parse_candidates]}
    wrappers = {"K1+K3": [predict.synthesize_epilogue],
                "K1": [predict.synthesize],
                "K2": [entropy.decode_residual_bits_stream],
                "K9": [entropy.decode_residual_bits],
                "K10": [entropy.decode_residual_bits_stream_delta],
                "K4": [crc.crc16_ranges],
                "K3b_pack": [epilogue.pack_int16_pairs],
                "K3b_unpack": [epilogue.unpack_int16_pairs], **seg_wrappers,
                **{k: [w] for k, w in test_only.items()}}
    # K3's torch ops are the fused kernel's plain form: count their calls
    # on card tensors (there must be none on a decode path).
    plain_k3 = epilogue.apply_epilogue
    k3_on_card = [0]

    def counted_k3(samples, wasted, pair_modes):
        k3_on_card[0] += samples.device.type != "cpu"
        return plain_k3(samples, wasted, pair_modes)

    def drive(path_kernels, fn):
        """Run fn with every launch count at 0; return every kernel's count
        (a kernel's count sums its wrappers), the path's kernels at least
        1 each. K1 alone, K3's torch ops and the parent front's wrappers
        must not run on the card; on
        the default routes (neither entropy variable set) K9 and K10 must
        not run either, and K7 must emit no deltas."""
        for ws in wrappers.values():
            for w in ws:
                w.launches = 0
        demux.walk_frames.delta_launches = 0
        k3_on_card[0] = 0
        epilogue.apply_epilogue = predict.apply_epilogue = counted_k3
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            epilogue.apply_epilogue = predict.apply_epilogue = plain_k3
        counts = {k: sum(w.launches for w in ws)
                  for k, ws in wrappers.items()}
        counts["K7_with_deltas"] = demux.walk_frames.delta_launches
        for k in path_kernels:
            if any(w.launches <= 0 for w in wrappers[k]):
                raise AssertionError(f"{k} was not launched by the path "
                                     f"(counts {counts})")
        if counts["K5_K6_parent"]:
            raise AssertionError(f"the path ran the parent front's wrappers "
                                 f"(counts {counts})")
        if any(counts[k] for k in test_only):
            raise AssertionError(f"the path ran rice_decode, crc16_device "
                                 f"or crc16_frames_device (counts {counts})")
        if predict.synthesize.launches or k3_on_card[0]:
            raise AssertionError(
                f"the path ran K1 alone {predict.synthesize.launches} "
                f"time(s) and K3's torch ops on the card {k3_on_card[0]} "
                "time(s)")
        default = not any(os.environ.get(v) for v in (
            "CLAXON_TPU_ENTROPY", "CLAXON_TPU_SEG_ENTROPY"))
        if default and (counts["K9"] or counts["K10"]
                        or counts["K7_with_deltas"]):
            raise AssertionError(f"a default route ran K9, K10 or K7's "
                                 f"deltas (counts {counts})")
        counts["K3_torch_ops_on_card"] = k3_on_card[0]
        return out, counts

    def fetched(dd):
        dd.to_host()
        return dd

    def to_host_checked(label, datas, dd):
        """to_host() through the int16 transfer, checked against the
        scalar decoder; prints what packed and the bytes copied back. A
        bucket must pack exactly when all its streams are 16-bit or
        narrower, and none may need the int32 refetch."""
        res = dd.to_host()
        check_decoded(label, datas, res)
        n, packed, refetched, nbytes = fetch_stats(dd)
        log(f"(c) {label}: {packed} of {n} buckets came back as int16 "
            f"pairs, {refetched} refetched as int32, {nbytes} bytes copied "
            "back")
        want = [all(res[run[0]].streaminfo.bits_per_sample <= 16
                    for run in plan) for plan in dd.lane_plans()]
        if refetched or [d.packed for d in dd.dispatches] != want:
            raise AssertionError(f"{label}: packed "
                                 f"{[d.packed for d in dd.dispatches]}, "
                                 f"expected {want}; {refetched} refetched")
        return nbytes

    def phase_auto():
        """The default route: segmentation=None with CLAXON_TPU_SEGMENTATION
        unset calibrates ("auto") on the batch and keeps the faster path
        for the process and the card. Mixed, then headline (whose choice
        stays cached for the default-route calls after this); then the
        pipelined loop pinned to the host walk (every handle finished when
        it is begun), and through the default route on the segmented path,
        and its depth 2 against 6."""
        from claxon_tpu_torch import pipeline as tp

        os.environ.pop("CLAXON_TPU_SEGMENTATION", None)
        auto = {}
        for label, datas in (("mixed", mixed),
                             (f"headline x{HEADLINE_REPLICAS}", datas4)):
            tp._SEG_AUTO.clear()
            t0 = time.perf_counter()
            dd = ct.decode_streams_device(datas, device=DEVICE)
            cal_ms = (time.perf_counter() - t0) * 1e3
            choice, secs = (tp._seg_auto(DEVICE)["choice"],
                            tp._seg_auto(DEVICE)["seconds"])
            if secs is None or dd.segmented != (choice == "device"):
                raise AssertionError(f"{label}: auto did not time both "
                                     f"paths (choice {choice})")
            check_decoded(f"{label}, auto (chose {choice})", datas,
                          dd.to_host())
            auto[label] = {"choice": choice,
                           "device_ms": secs["device"] * 1e3,
                           "host_ms": secs["host"] * 1e3,
                           "calibration_ms": cal_ms}
            log(f"(c) auto on {label}: chose {choice}; min of 2 synced "
                f"decodes: device {secs['device'] * 1e3:.2f} ms, host "
                f"{secs['host'] * 1e3:.2f} ms; the calibration took "
                f"{cal_ms:.1f} ms")
        choice = tp._seg_auto(DEVICE)["choice"]

        def pipelined(depth=2):
            return ct.decode_streams_pipelined(datas4, batch_streams=8,
                                               depth=depth, device=DEVICE)

        def pinned(value):
            os.environ["CLAXON_TPU_SEGMENTATION"] = value
            try:
                return drive(path_k[value], pipelined)
            finally:
                del os.environ["CLAXON_TPU_SEGMENTATION"]

        path_k = {"host": ("K1+K3", "K2", "K4", "K3b_pack"),
                  "device": ("K1+K3", "K4", "K5", "K6", "K7", "K8",
                             "K3b_pack")}
        res, counts = pinned("host")
        check_decoded(f"headline x{HEADLINE_REPLICAS}, pipelined in batches "
                      "of 8 on the host walk", datas4, res)
        log(f"(c) pipelined in batches of 8 (host walk), launches: {counts}")
        if choice == "device":
            res, counts = drive(path_k["device"], pipelined)
        else:
            res, counts = pinned("device")
        check_decoded(f"headline x{HEADLINE_REPLICAS}, pipelined in batches "
                      "of 8 through the segmented path", datas4, res)
        log(f"(c) pipelined in batches of 8 (segmented, each batch landed "
            f"after the next began), launches: {counts}")
        depth_ms = {2: [], 6: []}
        for depth in (2, 6, 6, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipelined(depth)
            depth_ms[depth].append((time.perf_counter() - t0) * 1e3)
        log(f"(c) pipelined to host through the default route ({choice}), "
            f"batches of 8, runs in the order 2, 6, 6, 2: depth 2 "
            f"{depth_ms[2][0]:.1f}, {depth_ms[2][1]:.1f} ms; depth 6 "
            f"{depth_ms[6][0]:.1f}, {depth_ms[6][1]:.1f} ms")
        return auto, counts, depth_ms

    auto, pipe_launches, depth_ms = phase_auto()

    dd, launches = drive(
        ("K1+K3", "K2", "K4", "K3b_pack", "K3b_unpack"),
        lambda: fetched(ct.decode_streams_device(datas4, segmentation="host",
                                                 device=DEVICE)))
    host_launches = dict(launches)
    res = dd.results
    log(f"(c) host-walk path, launches in the headline decode to host: "
        f"{launches}")
    back = to_host_checked(f"headline x{HEADLINE_REPLICAS}, to host", datas4,
                           dd)
    L, T = dd.dispatches[0].out_full.shape
    # At the full size the bucket is (6912, 4096): 56,623,104 bytes.
    if back != L * T * 2 + 4 or T != 4096:
        raise AssertionError(f"headline bucket {(L, T)}: {back} bytes "
                             f"copied back, expected {L * T * 2} + the flag")
    log(f"(c) K1+K3 on the main bucket ({main_shape}): "
        f"{rows['K1+K3'][1]:.4f} ms, bound {bounds['K1+K3'][0]:.4f} ms "
        f"({bounds['K1+K3'][1]}), {launches['K1+K3']} launch(es) in the "
        "headline decode; K1 alone and K3's torch ops ran on the card 0 "
        "times")
    total_samples = sum(r.pcm.size for r in res)
    check_decoded(f"headline x{HEADLINE_REPLICAS}, decode_streams (the "
                  "default route)", datas4,
                  ct.decode_streams(datas4, device=DEVICE))
    # The mixed corpus packs every bucket but the 24-bit stream's.
    to_host_checked("mixed", mixed,
                    ct.decode_streams_device(mixed, segmentation="host",
                                             device=DEVICE))
    to_host_checked("generated", generated,
                    ct.decode_streams_device(generated, segmentation="host",
                                             device=DEVICE))
    # Fallback-frame buckets only (no bits bucket, so no K2).
    fb_dd, fb_launches = drive(
        ("K1+K3", "K4"),
        lambda: ct.decode_streams_device(fallback, segmentation="host",
                                         device=DEVICE))
    check_decoded("fallback corpus", fallback, fb_dd.to_host())
    log(f"(c) fallback corpus, launches: {fb_launches}")
    check_decoded("generated, one stream at a time (the default route, "
                  "use_native=True passed positionally)",
                  generated,
                  [ct.decode_stream(d, True, device=DEVICE)
                   for d in generated])
    epilogue.pack_int16_pairs.launches = 0
    dd = ct.decode_streams_device(datas4, segmentation="host",
                                  device=DEVICE).sync()
    buckets = dd.device_buckets()
    dd.lane_plans()
    if not all(b[2].device.type == torch.device(DEVICE).type
               and b[2].dtype == torch.int32 for b in buckets):
        raise AssertionError("device_buckets() are not int32 tensors on "
                             "the card")
    if epilogue.pack_int16_pairs.launches:
        raise AssertionError("the device-resident path launched K3b pack")
    log("(c) sync(), device_buckets() and lane_plans() launched no K3b "
        "pack")
    check_decoded(f"headline x{HEADLINE_REPLICAS}, device-resident", datas4,
                  dd.to_host())

    def seg_decode(datas):
        return ct.decode_streams_device(datas, segmentation="device",
                                        device=DEVICE)

    dd, seg_launches = drive(
        ("K1+K3", "K4", "K5", "K6", "K7", "K8", "K3b_pack"),
        lambda: fetched(seg_decode(datas4)))
    launches.update({k: seg_launches[k] for k in seg_wrappers})
    log(f"(c) segmented path, launches in the headline decode to host: "
        f"{seg_launches}")
    if dd.fallback_streams or not dd.segmented:
        raise AssertionError(f"headline x{HEADLINE_REPLICAS}: streams "
                             f"{dd.fallback_streams} left the segmented "
                             "path")
    to_host_checked(f"headline x{HEADLINE_REPLICAS}, segmented", datas4, dd)
    epilogue.pack_int16_pairs.launches = 0
    seg_decode(datas4).sync().device_buckets()
    if epilogue.pack_int16_pairs.launches:
        raise AssertionError("the segmented device-resident path launched "
                             "K3b pack")
    for label, datas, want_fb in (
            ("mixed", mixed, [MIXED_SPECS.index(MIXED_24BIT)]),
            ("generated", generated,
             [i for i, n in enumerate(generated_names)
              if n == "sixchan.flac"])):
        dd, _calls = front_checked(f"{label} segmented",
                                   lambda: seg_decode(datas))
        log(f"(c) {label}, segmented: fallback streams "
            f"{dd.fallback_streams}")
        if not set(want_fb) <= set(dd.fallback_streams) or \
                len(dd.fallback_streams) >= len(datas):
            raise AssertionError(f"{label}: unexpected segmented "
                                 f"fallbacks {dd.fallback_streams}")
        to_host_checked(f"{label}, segmented", datas, dd)
    pend = ct.decode_streams_device_async(datas4, segmentation="device",
                                          device=DEVICE)
    check_decoded(f"headline x{HEADLINE_REPLICAS}, segmented async",
                  datas4, pend.finish().to_host())

    def phase_routes():
        """The JAX package's other entropy routes, each variable set only
        around its own calls: CLAXON_TPU_ENTROPY=delta on the host walk
        (K9, no K2 and no K4: the walk checks the CRCs),
        CLAXON_TPU_SEG_ENTROPY=delta (K7 with its deltas, then K10, no K8)
        and =scan (K2 on the walk's chunk bases, no K8). Each decodes
        headline x4 (launches counted), mixed and generated to host, held
        to the scalar decoder and the MD5, and is timed device-resident
        (median of 3 after a warm-up run)."""
        out = {}
        for var, value, seg, path in ENTROPY_ROUTES:
            route = f"{var}={value}"

            def decode(datas):
                return ct.decode_streams_device(datas, segmentation=seg,
                                                device=DEVICE)

            os.environ[var] = value
            try:
                dd, counts = drive(path, lambda: fetched(decode(datas4)))
                to_host_checked(f"headline x{HEADLINE_REPLICAS}, {route}",
                                datas4, dd)
                if seg == "host":
                    bad = counts["K2"] or counts["K4"]
                else:
                    bad = (counts["K8"] or dd.fallback_streams
                           or not dd.segmented or counts["K7_with_deltas"]
                           != (counts["K7"] if value == "delta" else 0))
                if bad:
                    raise AssertionError(f"{route}: unexpected launches "
                                         f"{counts} or fallbacks "
                                         f"{dd.fallback_streams}")
                for label, datas in (("mixed", mixed),
                                     ("generated", generated)):
                    to_host_checked(f"{label}, {route}", datas,
                                    decode(datas))
                runs = []
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    decode(datas4).sync()
                    runs.append((time.perf_counter() - t0) * 1e3)
            finally:
                del os.environ[var]
            med = statistics.median(runs[1:])
            log(f"(c) {route}: launches in the headline decode to host: "
                f"{counts}; device-resident {med:.1f} ms (median of "
                f"{', '.join(f'{t:.1f}' for t in runs[1:])}; warm-up "
                f"{runs[0]:.1f})")
            out[route] = {"launches": counts, "device_resident_ms": med,
                          "runs_ms": runs[1:]}
        return out

    t_routes = time.perf_counter()
    routes = phase_routes()
    log(f"(c) the entropy routes took {time.perf_counter() - t_routes:.1f} s")

    # The overflow case: garbage that leaves int16 behind valid CRCs.
    loud = overflow_stream()
    _si, want = native.decode_stream_scalar(loud)
    n_out = int((np.abs(want.astype(np.int64)) > 32767).sum())
    if not n_out:
        raise AssertionError("the overflow stream stays inside int16")
    for path in ("host", "device"):
        dd = ct.decode_streams_device([base[0], loud], segmentation=path,
                                      device=DEVICE)
        out = dd.to_host()
        check_decoded(f"overflow stream's neighbour, {path} path",
                      [base[0]], out[:1])
        # The damaged stream's MD5 cannot match: the PCM alone is held.
        if not np.array_equal(out[1].pcm, want):
            raise AssertionError(f"overflow stream, {path} path: PCM != "
                                 "scalar decoder")
        n, packed, refetched, nbytes = fetch_stats(dd)
        flags = [int(d.flag) for d in dd.dispatches if d.packed]
        if packed != n or refetched != 1 or sum(flags) != 1:
            raise AssertionError(f"overflow stream, {path} path: flags "
                                 f"{flags}, {refetched} refetched")
        log(f"(c) overflow stream, {path} path: {n_out} samples outside "
            f"int16 (max |x| {int(np.abs(want.astype(np.int64)).max())}); "
            f"flags {flags}, 1 bucket refetched as int32, PCM == scalar "
            "decoder")

    # (d) a corrupted stored frame CRC is refused, by K4 alone.
    bad = corrupt_first_frame_crc(base[0])
    for path in ("host", "device"):
        crc.crc16_ranges.launches = 0
        dd = ct.decode_streams_device([base[1], bad], segmentation=path,
                                      device=DEVICE)
        if dd.fallback_streams:
            raise AssertionError("the corrupted stream left the "
                                 "segmented path")
        try:
            dd.to_host()
        except ct.Error as e:
            if "frame CRC mismatch" not in str(e):
                raise
            log(f"(d) {path} path: corrupted frame refused: {e}")
        else:
            raise AssertionError("a corrupted frame CRC was not detected")
        try:
            dd.sync()
        except ct.Error as e:
            if "frame CRC mismatch" not in str(e):
                raise
        else:
            raise AssertionError("the CRC failure did not latch")
        if crc.crc16_ranges.launches != 1:
            raise AssertionError("K4 did not run once for the corrupted "
                                 "batch")
        log(f"(d) {path} path: the failure latches (sync() raises again); "
            "K4 ran once")
    # With the CRC check in the host walk (the host-CRC knob, and delta
    # mode), the corrupted frame raises from the call itself; K4 never runs.
    for var, value in (("CLAXON_TPU_HOST_CRC", "1"),
                       ("CLAXON_TPU_ENTROPY", "delta")):
        crc.crc16_ranges.launches = 0
        os.environ[var] = value
        try:
            ct.decode_streams_device([base[1], bad], segmentation="host",
                                     device=DEVICE)
        except ct.Error as e:
            if "frame CRC mismatch" not in str(e):
                raise
            log(f"(d) {var}={value}: the corrupted frame raised from "
                f"decode_streams_device itself: {e}")
        else:
            raise AssertionError(f"{var}={value}: the corrupted frame CRC "
                                 "did not raise from the call")
        finally:
            del os.environ[var]
        if crc.crc16_ranges.launches:
            raise AssertionError(f"{var}={value}: K4 ran")

    # (e) rates on the headline batch (samples = every channel's samples).
    def timed(fn):
        ts = []
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts), min(ts)

    ms = total_samples / 1e6
    log(f"(e) {card}: headline x{HEADLINE_REPLICAS}, {total_samples} "
        f"samples, median of {TIMED_RUNS}:")
    for path in ("host", "device"):
        timed(lambda: ct.decode_streams_device(
            datas4, segmentation=path, device=DEVICE).sync())
        res_s, res_min = timed(lambda: ct.decode_streams_device(
            datas4, segmentation=path, device=DEVICE).sync())
        host_s, host_min = timed(lambda: ct.decode_streams_device(
            datas4, segmentation=path, device=DEVICE).to_host())
        log(f"(e)   {path:6s} device-resident {ms / res_s:.2f} Ms/s "
            f"({res_s * 1e3:.1f} ms; best {ms / res_min:.2f} Ms/s); "
            f"to-host {ms / host_s:.2f} Ms/s ({host_s * 1e3:.1f} ms; best "
            f"{ms / host_min:.2f} Ms/s)")
    # The to-host tail, split by the program's spans: after sync() (the
    # buckets are on the card), claxon.fetch.start (K3b pack, the copies
    # into pinned memory queued) and claxon.fetch.wait (the wait for
    # them), then claxon.fetch.scatter (the strided scatter into
    # per-stream PCM); then the same with the int16 transfer switched off
    # on the dispatches. The bytes are the program's fetch_bytes.
    split = {}
    for path in ("host", "device"):
        for mode in ("int16", "int32"):
            waits, scatters = [], []
            for _ in range(TIMED_RUNS):
                dd = ct.decode_streams_device(datas4, segmentation=path,
                                              device=DEVICE).sync()
                if mode == "int32":
                    for d in dd.dispatches:
                        d.packed = False
                dd.to_host()
                rec = dd.trace
                waits.append(rec.seconds("claxon.fetch.start")
                             + rec.seconds("claxon.fetch.wait"))
                scatters.append(rec.seconds("claxon.fetch.scatter"))
            split[path, mode] = (statistics.median(waits) * 1e3,
                                 statistics.median(scatters) * 1e3,
                                 rec.counters["fetch_bytes"])
            w, sc, nb = split[path, mode]
            log(f"(e)   {path:6s} to-host tail, {mode} transfer ({nb} "
                f"bytes): pack + copy wait {w:.1f} ms (min "
                f"{min(waits) * 1e3:.1f}, max {max(waits) * 1e3:.1f}), "
                f"scatter {sc:.1f} ms (min {min(scatters) * 1e3:.1f}, max "
                f"{max(scatters) * 1e3:.1f}), median of {TIMED_RUNS}")
    del dd, rec
    walk_s, _ = timed(lambda: extract_streams_bits(datas4, native))
    braws = extract_streams_bits(datas4, native)
    plan_s, _ = timed(lambda: plan_raw_bits(braws, 128))
    log(f"(e)   host path: host walk {walk_s * 1e3:.1f} ms, planning "
        f"{plan_s * 1e3:.1f} ms; kernels on the main bucket "
        f"({main_shape}): K2 {rows['K2'][1]:.3f} ms, K1 "
        f"{rows['K1'][1]:.3f} ms, K4 ({k4_shape}) {rows['K4'][1]:.3f} ms")
    stages = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        stages.append(seg_decode(datas4).sync().stage_seconds)
    med = {k: statistics.median(st.get(k, 0.0) for st in stages)
           for k in stages[0]}
    log("(e)   segmented path host stages, median ms: " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in med.items()))
    log(f"(e)   segmented kernels ({rows['seg_shape']}): K5 "
        f"{rows['K5'][1]:.3f} ms, K6 {rows['K6'][1]:.3f} ms, K7 "
        f"{rows['K7'][1]:.3f} ms, K8 ({rows['k8_shape']}) "
        f"{rows['K8'][1]:.3f} ms")
    scalar_s, _ = timed(lambda: [native.decode_stream_scalar(d)
                                 for d in datas4])
    log(f"(e)   C++ scalar decode on the host: {ms / scalar_s:.2f} Ms/s")
    del braws, res
    k2_large = phase_f()
    g_launches = phase_g(base, mixed[MIXED_SPECS.index(MIXED_24BIT)])
    log(f"(g) launches in the first Ogg decode: {g_launches}")
    t_h = time.perf_counter()
    h_row, h_bound, h_launches, framedesc = phase_h(drive, datas4, mixed,
                                                    generated)
    log(f"(h) the FrameDesc route took {time.perf_counter() - t_h:.1f} s")
    t_i = time.perf_counter()
    i_host, i_seg, sharded = phase_i(drive, datas4, mixed, generated, base,
                                     host_launches, seg_launches, routes)
    log(f"(i) the sharded route took {time.perf_counter() - t_i:.1f} s")
    t_j = time.perf_counter()
    sample_shipping = phase_j(drive, datas4, mixed, generated, base)
    log(f"(j) the sample-shipping route took {time.perf_counter() - t_j:.1f} "
        "s")

    sources = {"K1+K3": ("claxon_tpu_torch/csrc/synth.cu",
                         "claxon_tpu/ops/pallas_synth.py:127"),
               "K2": ("claxon_tpu_torch/csrc/entropy.cu",
                      "claxon_tpu/ops/entropy.py:158"),
               "K9": ("claxon_tpu_torch/csrc/entropy_delta.cu",
                      "claxon_tpu/ops/entropy.py:54"),
               "K10": ("claxon_tpu_torch/csrc/entropy_delta.cu",
                       "claxon_tpu/ops/entropy.py:279"),
               "K4": ("claxon_tpu_torch/csrc/crc.cu",
                      "claxon_tpu/ops/crc.py:193"),
               "K5": ("claxon_tpu_torch/csrc/seg_parse.cu",
                      "claxon_tpu/ops/segment.py:74"),
               "K6": ("claxon_tpu_torch/csrc/seg_parse.cu",
                      "claxon_tpu/ops/seg_parse.py:164"),
               "K7": ("claxon_tpu_torch/csrc/demux.cu",
                      "claxon_tpu/ops/demux.py:516"),
               "K8": ("claxon_tpu_torch/csrc/seg_gather.cu",
                      "claxon_tpu/pipeline_seg.py:203"),
               "K3b_pack": ("claxon_tpu_torch/csrc/pack16.cu",
                            "claxon_tpu/ops/epilogue.py:78"),
               "K3b_unpack": ("claxon_tpu_torch/csrc/pack16.cu",
                              "claxon_tpu/ops/epilogue.py:101"),
               "rice_decode": ("claxon_tpu_torch/csrc/rice.cu",
                               "claxon_tpu/ops/rice.py:126"),
               "crc16_device": ("claxon_tpu_torch/csrc/crc_lanes.cu",
                                "claxon_tpu/ops/crc.py:33"),
               "crc16_frames_device": ("claxon_tpu_torch/csrc/crc_lanes.cu",
                                       "claxon_tpu/ops/crc.py:284")}

    def entry(k, source, replaces):
        return {"name": k, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.get(k, 0),
                "max_abs_err": rows[k][0], "ms": rows[k][1],
                "plain_ms": rows[k][2], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": library.get(k)}

    # K9 and K10 run on their routes only: their launches are those of the
    # route's headline decode.
    launches["K9"] = routes["CLAXON_TPU_ENTROPY=delta"]["launches"]["K9"]
    launches["K10"] = \
        routes["CLAXON_TPU_SEG_ENTROPY=delta"]["launches"]["K10"]
    kernels = [entry(k, *src) for k, src in sources.items()]
    # K1 alone is an entry point of its own, not on a decode path.
    off_path = [entry("K1", *sources["K1+K3"])]
    for k in kernels + off_path:
        # Launches of the segmented headline decode and of the first
        # container decode, beside the host-walk path's.
        k["launches_segmented"] = seg_launches.get(k["name"], 0)
        k["launches_ogg"] = g_launches.get(k["name"], 0)
        # The FrameDesc route's headline x4 batch (h2).
        k["launches_framedesc"] = h_launches.get(k["name"], 0)
        # Headline x4 over two shards on the card (i): host walk and
        # segmented.
        k["launches_sharded"] = i_host.get(k["name"], 0)
        k["launches_sharded_segmented"] = i_seg.get(k["name"], 0)
        # ... and on the other entropy routes.
        k["launches_sharded_routes"] = {
            var + "=" + value: sharded["launches"][
                f"{var}={value}_two"].get(k["name"], 0)
            for var, value, _seg, _path in ENTROPY_ROUTES}
        if k["name"] == "K1+K3":
            k["also_replaces"] = "claxon_tpu/ops/epilogue.py:39"
            k["k1_alone_ms"] = rows["K1"][1]
            k["k3_torch_ops_ms"] = rows["K3"][1]
            k.update(ms_framedesc=h_row[1], plain_ms_framedesc=h_row[2],
                     max_abs_err_framedesc=h_row[0],
                     bound_ms_framedesc=h_bound[0])
        if k["name"] == "K4":
            k["ms_segmented"] = rows["K4_seg"][1]
            k["bound_ms_segmented"] = bounds["K4_seg"][0]
            for key, rep in (("", rows["K4_parent"]),
                             ("_segmented", rows["K4_seg_parent"])):
                k["parent_ms" + key] = rep["parent_ms"]
                k["runs" + key] = rep.get("runs")
        if k["name"] == "K2":
            rep = rows["K2_buckets"][0]  # the headline bucket
            k["parent_ms"], k["runs"] = rep["parent_ms"], rep.get("runs")
            # Every mixed and large-stream bucket: new and parent time,
            # bound.
            k["buckets"] = rows["K2_buckets"][1:] + k2_large
            # The segmented scan route's dispatches (the largest headline
            # one first in these keys).
            k.update(ms_scan=rows["K2_scan"][1],
                     plain_ms_scan=rows["K2_scan"][2],
                     bound_ms_scan=bounds["K2_scan"][0],
                     launches_scan=routes["CLAXON_TPU_SEG_ENTROPY=scan"]
                     ["launches"]["K2"],
                     scan_dispatches=rows["K2_scan_buckets"])
        if k["name"] in ("K9", "K10"):
            # Beside the parent kernel (csrc/entropy_delta_parent.cu) on
            # the same inputs; every headline and mixed bucket or dispatch.
            main_rep = rows[k["name"] + "_main"]
            k.update(shape=rows[k["name"] + "_shape"],
                     parent_ms=main_rep["parent_ms"], runs=main_rep["runs"],
                     buckets=rows[k["name"] + "_buckets"])
        if k["name"] == "K3b_unpack":
            k["ms_mb_tail"] = rows["unpack_mb_tail_ms"]
        if k["name"] == "rice_decode":
            # "launches" counts wrapper calls, each two kernel launches
            # (every lane alone, then the exact pass that returns at once
            # unless a lane ran off the buffer); "ms" times both.
            k["kernel_launches_per_call"] = 2
            k["one_warp_ms"] = rows["rice_decode_one_warp_ms"]
        if k["name"] in ("rice_decode", "crc16_frames_device"):
            # Beside the parent kernel (csrc/rice_parent.cu,
            # csrc/crc_lanes_parent.cu) on the same inputs; rice_decode's
            # first 32 lanes alone too, crc16_frames_device beside K4.
            k.update({key: v for key, v in
                      rows[k["name"] + "_parent"].items() if key != "ms"})
        if k["name"] in ("K5", "K6"):
            # One fused front (csrc/seg_parse.cu, demux_front: the scan
            # kernel, then the rank kernel) does K5's work and K6's
            # bswap, fields and compaction; K6 adds the summary kernel.
            # The parent's seven operations (bswap, K5's three launches and
            # torch.cumsum, fields, compaction) timed beside it in the
            # same call; every headline and mixed group.
            front = rows["front_groups"][0]
            k.update(front_ms=front["ms"], parent_ms=front["parent_ms"],
                     runs=front["runs"], front_bound_ms=front["bound_ms"],
                     groups=rows["front_groups"],
                     parent_pieces_ms=rows["K5_K6_parent"][1])
        if k["name"] == "K6":
            k["summary_ms"] = rows["K6_summary"][1]
        if k["name"] == "K7":
            # "launches" counts wrapper calls, each two kernel launches
            # (walk, then values). Each segmented group: new and parent
            # time, bound, cycles per step.
            k["kernel_launches_per_call"] = 2
            k["groups"] = rows["K7_groups"]
            k["ms_with_deltas"] = rows["K7_deltas_ms"]
            k["launches_with_deltas"] = \
                routes["CLAXON_TPU_SEG_ENTROPY=delta"]["launches"][
                    "K7_with_deltas"]
    torch_ops = [{"name": k, "source": src, "ms": rows[k][1],
                  "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
                 for k, src in (
                     ("K3", "claxon_tpu_torch/ops/epilogue.py"),
                     ("unpack_mb", "claxon_tpu_torch/pipeline_bits.py"))]
    # K3 alone runs on no card path: its calls on card tensors.
    torch_ops[0].update(
        launches=launches["K3_torch_ops_on_card"],
        launches_segmented=seg_launches["K3_torch_ops_on_card"])
    for k in kernels + torch_ops:
        if k["name"] in rows["paced"]:
            k["ms_paced"] = rows["paced"][k["name"]]
    to_host_tail = [{"path": path, "transfer": mode, "wait_ms": w,
                     "scatter_ms": sc, "bytes": nb}
                    for (path, mode), (w, sc, nb) in split.items()]
    log(f"total {time.perf_counter() - t_start:.0f} s after the corpora "
        "were encoded")
    print(json.dumps({"kernels": kernels, "off_path_kernels": off_path,
                      "torch_ops": torch_ops,
                      "to_host_tail": to_host_tail,
                      "auto": auto,
                      "routes": {r: {"device_resident_ms":
                                     v["device_resident_ms"],
                                     "runs_ms": v["runs_ms"]}
                                 for r, v in routes.items()},
                      "pipelined": {"launches": pipe_launches,
                                    "depth_ms": depth_ms},
                      "framedesc": framedesc,
                      "sharded": sharded,
                      "sample_shipping": sample_shipping}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
