#!/usr/bin/env python
"""Feed decoded FLAC straight into a consumer on the card, with no PCM
copied back (the PyTorch port's counterpart of
``examples/device_consumer.py``).

``decode_streams_device`` leaves the PCM on the card as fixed-shape
(lanes, time) int32 buckets. After ``sync()`` (which also surfaces the
frame CRC-16 verdict the card computed), a consumer reads them where
they lie: here torch ops take each lane's RMS level and zero-crossing
rate, the stand-in for a feature extractor or a training input
pipeline. ``lane_plans()`` says which stream, channel and samples each
lane holds, so padding lanes and the columns past a frame's length are
never read. Only the compressed FLAC goes up and a few sums per stream
come back.

Usage: python examples/device_consumer_torch.py [--cpu] FILE [FILE ...]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch


def lane_stats(dd):
    """{(stream, channel): (RMS, zero-crossing rate)} of a synced
    DeviceDecoded, computed on its buckets' device: per lane the sum of
    squares and the sign changes over its frame's samples, summed per
    (stream, channel) on the device; the small totals come back."""
    totals = {}
    for (_frames, _nch, bucket), plan in zip(dd.device_buckets(),
                                             dd.lane_plans()):
        for si, _out0, nf, bs, nch, lane0 in plan:
            x = bucket[lane0:lane0 + nf * nch, :bs].to(torch.float64)
            sq = (x * x).sum(dim=1)
            zc = ((x[:, 1:] * x[:, :-1]) < 0).sum(dim=1)
            run = torch.stack([sq.reshape(nf, nch).sum(dim=0),
                               zc.reshape(nf, nch).sum(dim=0)
                               .to(torch.float64)]).cpu().numpy()
            for ch in range(nch):
                t = totals.setdefault((si, ch), np.zeros(4))
                t += (run[0, ch], run[1, ch], nf * bs, nf * (bs - 1))
    return {key: (float(np.sqrt(sq / max(n, 1))), float(zc / max(pairs, 1)))
            for key, (sq, zc, n, pairs) in sorted(totals.items())}


def analyze(datas, device="cuda"):
    """Decode ``datas`` onto ``device`` and take the per-channel stats
    there; returns (the DeviceDecoded, :func:`lane_stats`)."""
    from claxon_tpu_torch import decode_streams_device

    dd = decode_streams_device(datas, device=device).sync()
    return dd, lane_stats(dd)


def main(argv):
    device = "cuda"
    if argv[:1] == ["--cpu"]:
        device, argv = "cpu", argv[1:]
    if not argv:
        print(__doc__)
        return 1
    datas = [pathlib.Path(f).read_bytes() for f in argv]
    dd, stats = analyze(datas, device)
    for i, (fname, d) in enumerate(zip(argv, dd.results)):
        print(f"{fname}: {d.pcm.shape[0]} samples x "
              f"{d.streaminfo.channels} ch decoded on {device}")
        for ch in range(d.streaminfo.channels):
            rms, zcr = stats.get((i, ch), (0.0, 0.0))
            print(f"  channel {ch}: RMS {rms:10.1f}  ZCR {zcr:6.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
