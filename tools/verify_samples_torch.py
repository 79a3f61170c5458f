#!/usr/bin/env python
"""Corpus-scale verification of the PyTorch port (``claxon_tpu_torch``):
every file bit-exact through the device pipeline, at scale.

* ``python tools/verify_samples_torch.py DIR`` -- walk DIR recursively and
  verify every ``*.flac`` found (the committed ``testsamples/`` work, and
  so does a music library).
* ``python tools/verify_samples_torch.py --generate N [--seed S]`` -- N
  streams of random audio content and random encoder configuration
  (block size, LPC order, partition order, stereo mode, rice2, bit depth,
  channels, wasted bits, forced subframe types, variable blocking), made
  with the port's own encoder (``claxon_tpu_torch.testing``), verified the
  same way. The STREAMINFO MD5 comes from the original PCM, so an encoder
  fault cannot confirm a matching decoder fault.

Per file, three checks:
  1. the C++ scalar decode matches the STREAMINFO MD5 (and, for a
     generated stream, the original PCM);
  2. the batched device pipeline is bit-identical to 1 -- files are
     decoded in batches, on the host walk (``segmentation="host"``), or
     with ``--segmented`` on the segmented path, which also reports how
     many streams rode the device demux and how many took the per-stream
     host walk;
  3. metadata: a metadata-only reader parses the same STREAMINFO.

Exit code 0 only when every file passes. The device is the card
(``cuda``); ``--cpu`` runs every kernel's plain PyTorch form on the CPU
instead (slow: keep ``--max-samples`` small there).
"""

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def random_stream(rng, max_samples=44100):
    """One (FLAC stream, PCM) of random content and encoder configuration
    (the reference tool's distribution)."""
    from claxon_tpu_torch.testing import encode_flac, synth_music

    bps = int(rng.choice([8, 12, 16, 20, 24]))
    channels = int(rng.choice([1, 2, 2, 2, 3, 4]))  # stereo-weighted
    n = int(rng.integers(1, max_samples))
    pcm = synth_music(n, channels=channels, bps=bps,
                      seed=int(rng.integers(0, 1 << 31)))
    if rng.random() < 0.1:  # silence stretches exercise constant frames
        a = int(rng.integers(0, n + 1))
        b = int(rng.integers(a, n + 1))
        pcm[a:b] = 0
    if rng.random() < 0.1:  # wasted bits
        pcm &= ~np.int64((1 << int(rng.integers(1, 4))) - 1)
    kw = dict(
        block_size=int(rng.choice([192, 576, 1024, 1152, 2048, 4096,
                                   4608])),
        max_lpc_order=int(rng.choice([0, 2, 4, 8, 12, 16])),
        # Up to order 7 = 128 partitions: more than 64 sends a stream
        # from the segmented path to the per-stream host walk.
        partition_order=int(rng.integers(0, 8)),
        rice2=bool(rng.random() < 0.25),
        lpc_precision=int(rng.choice([12, 14, 15])),
    )
    if channels == 2:
        kw["stereo"] = str(rng.choice(["auto", "independent", "left_side",
                                       "right_side", "mid_side"]))
    if rng.random() < 0.15:
        kw["force_subframe"] = str(rng.choice(["constant", "verbatim",
                                               "fixed"]))
        if kw["force_subframe"] == "constant":
            pcm[:] = pcm[0]
    if rng.random() < 0.2:
        kw["variable_blocking"] = True
    data = encode_flac(pcm, 44100, bps, **kw)
    return data, pcm.astype(np.int32)


def verify_batch(datas, origs, device, segmented, seg_stats):
    """The three checks over one batch; returns [(index, reason), ...].
    ``seg_stats`` counts the streams that rode the device demux and those
    that took the host walk (``--segmented``)."""
    from claxon_tpu_torch import FlacReader, FlacReaderOptions, native
    from claxon_tpu_torch.pipeline import decode_streams_device
    from claxon_tpu_torch.testing import pcm_md5

    fails = []
    scalar = []
    for i, data in enumerate(datas):
        si, pcm = native.decode_stream_scalar(data)
        if si.md5sum != b"\x00" * 16 and \
                pcm_md5(pcm, si.bits_per_sample) != si.md5sum:
            fails.append((i, "scalar decode does not match STREAMINFO MD5"))
        if origs[i] is not None and not np.array_equal(pcm, origs[i]):
            fails.append((i, "scalar decode does not match original PCM"))
        scalar.append(pcm)
        r = FlacReader(data, FlacReaderOptions(metadata_only=True,
                                               read_vorbis_comment=True))
        if r.streaminfo().channels != si.channels:
            fails.append((i, "metadata-only streaminfo mismatch"))
    # Pinned to one path: the default "auto" would calibrate on the first
    # batch and keep the winner.
    dd = decode_streams_device(
        datas, segmentation="device" if segmented else "host",
        device=device)
    if segmented:
        fb = set(dd.fallback_streams) if dd.segmented else \
            set(range(len(datas)))
        seg_stats["fallback"] += len(fb)
        seg_stats["device"] += len(datas) - len(fb)
    for i, (dec, pcm) in enumerate(zip(dd.to_host(), scalar)):
        if not np.array_equal(dec.pcm, pcm):
            fails.append((i, "device pipeline is not bit-identical to the "
                             "scalar decoder"))
    return fails


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?", help="directory of .flac files")
    ap.add_argument("--generate", type=int, default=0,
                    help="generate and verify N random streams")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-samples", type=int, default=44100,
                    help="longest generated stream, in samples a channel")
    ap.add_argument("--cpu", action="store_true",
                    help="decode with device='cpu' (the plain forms)")
    ap.add_argument("--segmented", action="store_true",
                    help="check 2 on the segmented path")
    args = ap.parse_args(argv)

    from claxon_tpu_torch import native
    from claxon_tpu_torch.error import Error

    device = "cpu" if args.cpu else "cuda"
    seg_stats = {"device": 0, "fallback": 0}
    t0 = time.perf_counter()
    n_files = n_failed = 0

    def run_batch(names, datas, origs):
        nonlocal n_failed
        try:
            fails = verify_batch(datas, origs, device, args.segmented,
                                 seg_stats)
        except Error as e:
            print(f"FAIL batch {names[0]}..: decode error {e}")
            n_failed += len(datas)
            return
        for i, why in fails:
            print(f"FAIL {names[i]}: {why}")
        n_failed += len({i for i, _ in fails})

    batch = ([], [], [])
    if args.generate:
        rng = np.random.default_rng(args.seed)
        items = ((f"gen#{j}",) + random_stream(rng, args.max_samples)
                 for j in range(args.generate))
    elif args.dir:
        def walk():
            for p in sorted(pathlib.Path(args.dir).rglob("*.flac")):
                data = p.read_bytes()
                try:  # skip files that are (deliberately) invalid
                    native.decode_stream_scalar(data)
                except Error:
                    continue
                yield str(p), data, None
        items = walk()
    else:
        ap.error("give a directory or --generate N")
    for name, data, pcm in items:
        n_files += 1
        for part, v in zip(batch, (name, data, pcm)):
            part.append(v)
        if len(batch[1]) >= args.batch:
            run_batch(*batch)
            batch = ([], [], [])
    if batch[1]:
        run_batch(*batch)

    seg_note = ""
    if args.segmented:
        seg_note = (f" (segmented: {seg_stats['device']} via the device "
                    f"demux, {seg_stats['fallback']} per-stream host walks)")
    print(f"verified {n_files} files in {time.perf_counter() - t0:.1f} s: "
          f"{n_files - n_failed} ok, {n_failed} failed{seg_note}")
    return 1 if n_failed else 0


if __name__ == "__main__":
    sys.exit(main())
