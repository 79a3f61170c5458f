"""The port's tracer (``claxon_tpu_torch.trace``): each batch's spans and
counters on both decode paths, ``sync()`` and ``to_host()``, the
profiler's ranges, and records kept apart when batches interleave. CPU
with tiny streams (every kernel takes its plain form); the card's own
checks are marked ``cuda``."""

import numpy as np
import pytest
import torch

import claxon_tpu_torch as ct
import claxon_tpu_torch.pipeline_seg as tseg
from claxon_tpu_torch import native, trace
from claxon_tpu_torch.ops import _build
from claxon_tpu_torch.testing import encode_flac, synth_music

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")

SEG_BEGIN = ["metadata", "buffer", "upload", "demux_queue"]
SEG_FINISH = ["between", "summary", "chain", "plan_dispatch"]
#: a segmented batch's ``claxon.seg.*`` spans in the order they end: the
#: stages, with ``results`` (no stage) inside ``plan_dispatch``.
SEG_SPANS = ["claxon.seg." + s for s in SEG_BEGIN + SEG_FINISH[:-1]
             + ["results", "plan_dispatch"]]
FETCH = ["claxon.fetch.start", "claxon.fetch.wait", "claxon.fetch.scatter",
         "claxon.fetch.crc"]


@pytest.fixture(autouse=True)
def _clear_port_reject_cache():
    tseg._REJECT_CACHE.clear()
    yield
    tseg._REJECT_CACHE.clear()


def _enc(n, seed, channels=2, block_size=256):
    # Several frames: a one-frame stream falls back (its STREAMINFO block
    # size is 16).
    return encode_flac(synth_music(n, channels=channels, bps=16, seed=seed),
                       44100, 16, block_size=block_size)


def _batch(seed=1):
    return [_enc(700, seed), _enc(600, seed + 1)]


def _assert_scalar(datas, results):
    for data, dec in zip(datas, results):
        _si, pcm = native.decode_stream_scalar(data)
        assert np.array_equal(dec.pcm, pcm)


def _names(rec, prefix=""):
    return [s[0] for s in rec.spans if s[0].startswith(prefix)]


def test_segmented_spans_replace_the_stage_marks():
    """One segmented batch: ``claxon.seg.*`` in stage order under the
    root, one batch id, and ``stage_seconds`` the spans' seconds by stage
    with the keys it always had."""
    datas = _batch()
    dd = ct.decode_streams_device(datas, segmentation="device", device="cpu")
    assert dd.fallback_streams == []
    rec = dd.trace
    assert _names(rec, "claxon.seg.") == SEG_SPANS
    root, = [s for s in rec.spans if s[3] is None]
    assert root[0] == "claxon.decode"
    seg = [s for s in rec.spans if s[0].startswith("claxon.seg.")
           and s[0] != "claxon.seg.results"]
    assert {s[3] for s in seg} == {"claxon.decode"}
    assert {s[4] for s in rec.spans} == {rec.batch}
    assert all(root[1] <= s[1] <= s[2] <= root[2] for s in seg)
    assert list(dd.stage_seconds) == SEG_BEGIN + SEG_FINISH
    for s in seg:
        assert dd.stage_seconds[s[0][len("claxon.seg."):]] == \
            (s[2] - s[1]) / 1e9
    _assert_scalar(datas, dd.to_host())


def test_upload_group_bytes_counts_the_group_words():
    datas = _batch(3)
    pend = tseg.begin_segmented(datas, device="cpu")
    assert pend.trace.counters == {"upload_group_bytes": pend.upload_bytes,
                                   "seg_streams": len(datas)}
    assert pend.upload_bytes >= sum(map(len, datas)) - 2 * 8192
    _assert_scalar(datas, tseg.finish_segmented(pend).to_host())


def test_cpu_groups_are_not_staged(monkeypatch):
    """On the CPU every group takes a fresh buffer: no ``upload_staged``
    or ``upload_stage_grow`` count, and no staging buffer is kept."""
    monkeypatch.setattr(tseg, "_STAGING", {})
    datas = _batch(19)
    dd = ct.decode_streams_device(datas, segmentation="device", device="cpu")
    assert dd.trace.counters["upload_group_bytes"] > 0
    assert "upload_staged" not in dd.trace.counters
    assert "upload_stage_grow" not in dd.trace.counters
    assert tseg._STAGING == {}
    _assert_scalar(datas, dd.to_host())


def test_fallback_spans_land_in_the_batch():
    """A stream the demux cannot take (3 channels) host-walks inside
    ``claxon.seg.fallback``, its spans in the same record."""
    datas = [_enc(700, 5), _enc(600, 6, channels=3)]
    dd = ct.decode_streams_device(datas, segmentation="device", device="cpu")
    assert dd.fallback_streams == [1]
    rec = dd.trace
    assert {s[4] for s in rec.spans} == {rec.batch}
    assert list(dd.stage_seconds) == SEG_BEGIN + SEG_FINISH + ["fallback"]
    inner = [(s[0], s[3]) for s in rec.spans
             if s[0].startswith(("claxon.walk.", "claxon.decode"))]
    assert inner == [("claxon.walk.extract", "claxon.decode"),
                     ("claxon.walk.plan", "claxon.decode"),
                     ("claxon.walk.dispatch", "claxon.decode"),
                     ("claxon.decode", "claxon.seg.fallback"),
                     ("claxon.decode", None)]
    _assert_scalar(datas, dd.to_host())


def test_host_walk_spans_and_the_fetch():
    datas = _batch(7)
    dd = ct.decode_streams_device(datas, segmentation="host", device="cpu")
    rec = dd.trace
    assert _names(rec) == ["claxon.walk.extract", "claxon.walk.plan",
                           "claxon.walk.dispatch", "claxon.decode"]
    assert [s[3] for s in rec.spans] == ["claxon.decode"] * 3 + [None]
    assert dd.stage_seconds == {}
    dd.sync()
    _assert_scalar(datas, dd.to_host())
    assert _names(rec)[4:] == ["claxon.sync.wait", "claxon.sync.crc"] + FETCH
    assert {s[4] for s in rec.spans} == {rec.batch}
    assert rec.seconds("claxon.fetch.scatter") > 0
    assert rec in trace.recent()


def test_profiler_ranges_carry_the_span_names():
    """Under the profiler every span is also a CPU range of its name, and
    not of user scope (which the profiler mirrors on the device
    timeline). This is the CPU profile that ``torch.profiler.profile``
    runs, entered directly: the wrapper's first entry in a process
    imports ``torch.distributed`` and more, which takes seconds. The
    card's test goes through ``torch.profiler.profile`` and covers the
    segmented stages."""
    datas = _batch(9)
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        dd = ct.decode_streams_device(datas, segmentation="host",
                                      device="cpu")
        dd.sync().to_host()
    events = [ev for ev in prof.kineto_results.events()
              if ev.name().startswith("claxon.")]
    assert sorted(ev.name() for ev in events) == sorted(_names(dd.trace))
    assert len(events) == 10
    user = int(torch._C._profiler.RecordScope.USER_SCOPE)
    assert all(ev.device_type() == torch.autograd.DeviceType.CPU
               and ev.scope() != user for ev in events)


def test_no_profiler_builds_no_range(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a profiler range was built")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    datas = _batch(11)
    for segmentation in ("device", "host"):
        dd = ct.decode_streams_device(datas, segmentation=segmentation,
                                      device="cpu")
        _assert_scalar(datas, dd.sync().to_host())
        assert set(FETCH) <= set(_names(dd.trace))


def test_interleaved_batches_keep_their_own_spans(monkeypatch):
    """Batch B begins before batch A finishes: each record holds only its
    own batch's spans, one of each begin stage."""
    monkeypatch.setenv("CLAXON_TPU_SEGMENTATION", "device")
    a_datas, b_datas = _batch(13), _batch(15)
    a = ct.decode_streams_device_async(a_datas, device="cpu")
    b = ct.decode_streams_device_async(b_datas, device="cpu")
    dd_a = a.finish()
    dd_b = b.finish()
    assert dd_a.trace is not dd_b.trace
    for dd, datas in ((dd_a, a_datas), (dd_b, b_datas)):
        rec = dd.trace
        assert {s[4] for s in rec.spans} == {rec.batch}
        assert _names(rec, "claxon.seg.") == SEG_SPANS
        _assert_scalar(datas, dd.to_host())
    a_end = [s[2] for s in dd_a.trace.spans
             if s[0] == "claxon.seg.demux_queue"][0]
    b_start = [s[1] for s in dd_b.trace.spans
               if s[0] == "claxon.seg.metadata"][0]
    between, = [s for s in dd_a.trace.spans
                if s[0] == "claxon.seg.between"]
    assert between[1] >= a_end
    assert between[1] <= b_start <= between[2]


def test_merged_records():
    one, two = trace.Trace(), trace.Trace()
    with one.span("claxon.x"):
        one.count("n", 2)
    with two.span("claxon.y"):
        two.count("n", 3)
    assert trace.merged([one, one]) is one
    both = trace.merged([two, one])
    assert [s[0] for s in both.spans] == ["claxon.x", "claxon.y"]
    assert [s[4] for s in both.spans] == [one.batch, two.batch]
    assert both.counters == {"n": 5}


def test_kernel_library_load_is_a_process_span(monkeypatch):
    """``claxon.build`` on the process's record replaces the old
    ``build_seconds`` global (a library without entry points stands in
    for the kernels, which need nvcc)."""
    from claxon_tpu_torch.native.build import ensure_built

    lib = ensure_built()
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_library_path", lambda: lib)
    monkeypatch.setattr(_build, "_SIGNATURES", {})
    n = len(trace.process.spans)
    _build.load()
    assert [s[0] for s in trace.process.spans[n:]] == ["claxon.build"]
    assert not hasattr(_build, "build_seconds")


def test_seg_debug_marks_follow_the_stages(monkeypatch, capsys):
    """``CLAXON_TPU_SEG_DEBUG``: the marks are the stages' ends in order,
    after the batch's start."""
    monkeypatch.setenv("CLAXON_TPU_SEG_DEBUG", "1")
    pend = tseg.begin_segmented(_batch(17), device="cpu")
    dd = tseg.finish_segmented(pend)
    assert [b for b, _t in pend.stages.marks] == \
        ["start"] + list(dd.stage_seconds)
    assert "seg stage CPU ms:" in capsys.readouterr().out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trace_on_the_card(cuda):
    """On the card: the profiler shows every span as a host range and no
    ``claxon.*`` event on the device timeline; ``fetch_bytes`` is every
    host copy ``start_fetch()`` made (the landed arena and the CRCs), and
    every bucket was landed; ``claxon.build`` was recorded."""
    from torch.profiler import ProfilerActivity, profile

    datas = [_enc(44100, 19, block_size=4096), _enc(30000, 20)]
    ct.decode_streams_device(datas, segmentation="device",
                             device=cuda).to_host()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dd = ct.decode_streams_device(datas, segmentation="device",
                                      device=cuda)
        _assert_scalar(datas, dd.sync().to_host())
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    dev = torch.autograd.DeviceType.CUDA
    assert [ev.name() for ev in events if ev.device_type() == dev
            and ev.name().startswith("claxon.")] == []
    assert any(ev.device_type() == dev for ev in events)
    host = sorted(ev.name() for ev in events
                  if ev.name().startswith("claxon."))
    assert host == sorted(n for n in _names(dd.trace)
                          if n != "claxon.seg.between")
    copies = [t for d in dd.dispatches for leaf in d.leaves()
              for t in (leaf.words, leaf.flag, leaf.host) if t is not None]
    assert copies == []  # every bucket landed: the arena, then the CRCs
    copies = [dd._landed[0]] + (dd._crc_host or [])
    assert dd.trace.counters["fetch_bytes"] == sum(
        t.numel() * t.element_size() for t in copies)
    assert dd.trace.counters["fetch_landed_buckets"] == len(dd.dispatches)
    assert dd.trace.counters["fetch_scattered_buckets"] == 0
    assert dd.trace.counters["upload_group_bytes"] > 0
    assert "claxon.build" in [s[0] for s in trace.process.spans]
