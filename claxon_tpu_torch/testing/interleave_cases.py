"""Lane plans for ``ops.epilogue.interleave_runs``: seeded random buckets
of int32 garbage with the lane-plan runs that ``DeviceDecoded`` would
hold for them, which the CPU tests hold the plain form to
``DeviceDecoded.to_host()``'s scatter with and the card tests and
``chip_smoke.py`` hold the kernel to the plain form with. Imports numpy
only.
"""

import numpy as np

__all__ = ["plan_case", "headline_case", "CASE_SEEDS"]

#: the seeds of the random cases (each shape of case at least once).
CASE_SEEDS = tuple(range(12))

#: block sizes a case draws from: the common ones, odd ones and ones
#: that leave the 16-byte vectors (bs * nch not a multiple of 4).
_BLOCK_SIZES = (4096, 4096, 1152, 576, 192, 4608, 1023, 777, 3, 1, 64)


def plan_case(seed):
    """(buckets, plans, shapes) for seed ``seed``: ``buckets`` a list of
    (L, T) int32 arrays of garbage, ``plans`` each bucket's runs
    ``(stream, out0, n_frames, block_size, n_channels, first_lane)``,
    ``shapes`` each stream's PCM ``(samples, channels)``.

    Streams are mono, stereo or six-channel; a stream's frames are dealt
    to runs of one block size, a run's last frame often short (a tail
    frame, ``bs < T``); its runs go to several buckets of its channel
    count (the chunks of one stream, or a fallback stream's frames, as
    ``merge_decoded`` shifts them), in shuffled order with unused
    padding lanes between them; some frames land in no bucket, so their
    samples stay zero."""
    rng = np.random.default_rng(seed)
    T = int(rng.choice([64, 192, 1152, 4096, 4608, 65535]
                       if seed % 3 else [4096, 4608]))
    n_streams = int(rng.integers(1, 6))
    shapes, runs_by_nch = [], {}
    for si in range(n_streams):
        nch = int(rng.choice([1, 2, 2, 6]))
        out0 = 0
        for _ in range(int(rng.integers(0, 5))):
            bs = int(rng.choice([b for b in _BLOCK_SIZES if b <= T] + [T]))
            nf = int(rng.integers(1, 4))
            if rng.random() < 0.85:  # else the run's frames land nowhere
                runs_by_nch.setdefault(nch, []).append((si, out0, nf, bs))
            out0 += nf * bs
            if rng.random() < 0.5 and bs > 1:  # a short tail frame
                tail = int(rng.integers(1, bs))
                runs_by_nch.setdefault(nch, []).append((si, out0, 1, tail))
                out0 += tail
        shapes.append((out0, nch))
    buckets, plans = [], []
    for nch, runs in sorted(runs_by_nch.items()):
        rng.shuffle(runs)
        # Deal the runs to one or two buckets of this channel count.
        split = int(rng.integers(0, len(runs) + 1))
        for part in (runs[:split], runs[split:]):
            if not part:
                continue
            plan, lane = [], int(rng.integers(0, 3))
            for si, out0, nf, bs in part:
                plan.append((si, out0, nf, bs, nch, lane))
                lane += nf * nch + int(rng.integers(0, 2)) * nch
            L = lane + int(rng.integers(0, 5))
            buckets.append(rng.integers(-2**31, 2**31, (L, T),
                                        dtype=np.int64).astype(np.int32))
            plans.append(plan)
    return buckets, plans, shapes


def headline_case(n_streams, n_frames, bs, nch, T=4096, seed=0):
    """One bucket at a decode's shape: ``n_streams`` streams of
    ``n_frames`` frames of ``bs`` samples each (the last frame of each
    stream ``bs // 3`` long), ``nch`` channels, lanes in stream order, the
    bucket's lanes padded to a multiple of 128. (buckets, plans, shapes)
    as :func:`plan_case`."""
    rng = np.random.default_rng(seed)
    plan, shapes, lane = [], [], 0
    for si in range(n_streams):
        plan.append((si, 0, n_frames - 1, bs, nch, lane))
        lane += (n_frames - 1) * nch
        plan.append((si, (n_frames - 1) * bs, 1, bs // 3, nch, lane))
        lane += nch
        shapes.append(((n_frames - 1) * bs + bs // 3, nch))
    L = (lane + 127) // 128 * 128
    bucket = rng.integers(-32768, 32768, (L, T), dtype=np.int64)
    return [bucket.astype(np.int32)], [plan], shapes
