"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, one precision below what the
configuration states (the least significant bit of every sample
dropped: 15 bits for a 16-bit configuration, 23 for a 24-bit one).
The control must come out as not correct; its readings are the upper
ends from which the limits were set (PERF.md).

    python3 flacbench/control.py --workload <cell> --seeds <n> [<n> ...]

It builds each seed's batches as a run does, places the control's PCM
as the program places its output (on the card, in the lanes a
``lane_plans()`` run describes, for a device cell; per-stream arrays for
a host cell), and prints, for each seed, the numbers the check compares.
The benchmark's own runs never run it.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


class Placed:
    """Per-stream (samples, channels) PCM in one (lanes, block) bucket per
    stream, frame-major and channel-minor, as ``device_buckets()`` and
    ``lane_plans()`` describe a program's output."""

    def __init__(self, pcms, block_size, device):
        import torch

        self._buckets, self._plans = [], []
        for si, pcm in enumerate(pcms):
            n, ch = pcm.shape
            nf = n // block_size
            lanes = pcm.reshape(nf, block_size, ch).transpose(0, 2, 1)
            self._buckets.append(([], ch, torch.from_numpy(
                lanes.reshape(nf * ch, block_size).copy()).to(device)))
            self._plans.append([(si, 0, nf, block_size, ch, 0)])

    def device_buckets(self):
        return list(self._buckets)

    def lane_plans(self):
        return [list(p) for p in self._plans]


class _Stream:
    def __init__(self, pcm):
        self.pcm = pcm


def control_counts(bench, cell_name, seed, device):
    """{number: value} of the control over every distinct batch of the
    cell for ``seed``."""
    from flacbench.gen.assemble import seed_batches
    from flacbench.gen.pool import load_pool
    from flacbench.reference import check

    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    pool, _ = load_pool(config)
    counts = {}
    for batch in seed_batches(pool, mix, seed):
        pcms = [check.expected(pool, t) & ~1 for t in batch]
        if mix["entry"] == "device":
            got = check.compare_device(
                Placed(pcms, config["block_size"], device), batch, pool)
        else:
            got = check.compare_host([_Stream(p) for p in pcms], batch, pool)
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description="the control of `correct`")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from flacbench.harness import Bench

    bench = Bench()
    for seed in args.seeds:
        counts = control_counts(bench, args.workload, seed, args.device)
        correct = all(v <= 0 for v in counts.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": correct, "compared": counts}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
