"""The benchmark's arithmetic on synthetic profiler events and calls
(CPU)."""

import statistics

import pytest

from flacbench import measure


def test_union_counts_each_instant_once():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 11.0)]
    assert measure.union_seconds(iv) == pytest.approx(3.0 + 1.0)
    # The per-row sum this replaces would say 4.6.
    assert sum(b - a for a, b in iv) == pytest.approx(4.6)
    assert measure.union_seconds(iv, 0.75, 3.5) == pytest.approx(1.25 + 0.5)
    assert measure.union_seconds([]) == 0


def test_idle_gaps_and_their_labels():
    busy = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    gaps = measure.idle_gaps(busy, 0.0, 8.0)
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 8.0)]
    spans = [("decode", 0.0, 4.5), ("seg_begin", 0.1, 0.9),
             ("sync", 4.5, 7.5)]
    labels = measure.label_gaps(gaps, spans)
    # (0, 1) midpoint 0.5: inside decode and the inner seg_begin;
    # (3, 5) midpoint 4: decode; (6, 8) midpoint 7: sync.
    assert labels == {"seg_begin": 1.0, "decode": 2.0, "sync": 2.0}
    assert measure.label_gaps([(9.0, 9.5)], spans) == {"other": 0.5}


def test_p95_is_nearest_rank_over_every_value():
    vals = list(range(1, 201))           # 200 calls
    assert measure.p95(vals) == 190      # ten values beyond it
    assert measure.p95([5.0]) == 5.0
    assert measure.p95([]) is None


def test_window_rate_counts_only_calls_done_in_the_window():
    calls = [{"start": 0.0, "done": 1.0, "samples": 100},
             {"start": 1.0, "done": 2.5, "samples": 100},
             {"start": 2.5, "done": 4.5, "samples": 100}]   # straddles 4.0
    got = measure.counted(calls, t_end=4.0)
    assert [c["done"] for c in got] == [1.0, 2.5]
    assert measure.window_rate(got, t_start=0.0) == pytest.approx(200 / 2.5)
    assert measure.window_rate([], 0.0) is None


def test_least_bytes_of_a_batch():
    # 4 tracks of 21,168,128 samples and 27 MB of FLAC each.
    assert measure.least_bytes(4 * 27_000_000, 4 * 21_168_128) == \
        4 * 27_000_000 + 16 * 21_168_128


def test_spread_uses_python_quartiles():
    vals = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert measure.spread(vals) == pytest.approx((q3 - q1) / 100.25)
