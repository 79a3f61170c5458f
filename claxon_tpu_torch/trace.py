"""Spans and counters of the port's host stages, one record per batch.

A record (:class:`Trace`) belongs to one batch. ``decode_streams_device``
makes it and opens its root span ``claxon.decode``; ``begin_segmented``
makes one when its caller passes none (``decode_streams_device_async``).
``pipeline_seg._SegPending`` carries it from ``begin_segmented`` to
``finish_segmented``, the batch's ``DeviceDecoded`` keeps it as
``dd.trace`` (``sync()`` and ``to_host()`` add their spans there), and
``merge_decoded`` merges the records of its parts. Nothing holds a
current record: each stage names the record it writes to, so batches
whose stages interleave (``decode_streams_device_async``,
``decode_streams_pipelined``) each keep their own spans.

A span is a tuple ``(name, start_ns, end_ns, parent, batch)``: its name,
its start and end on ``time.perf_counter_ns``, the name of the span of
the same record that was open when it started (None for a root), and the
record's batch id. A counter is a number in ``Trace.counters``. Spans go
around stages, never inside a per-frame or per-sample loop; with no
profiler active a span costs two clock reads and one append.

While a ``torch.profiler`` profile is active, each span also opens a
profiler range of its name, so every stage lies on the profiler's
timeline, on the clock of the device's events, and an idle gap of the
device can be put down to the innermost span open across it. The range
is of function scope (``torch._C._profiler._RecordFunctionFast``):
``torch.profiler.record_function`` opens one of user scope, which the
profiler mirrors on the device timeline, where a reading of device
activity would count it as device time.

Spans, all named ``claxon.*``:

=====================================  =====================================
``claxon.decode``                      ``decode_streams_device``, the root
``claxon.calibrate``                   ``"auto"`` timing both paths
``claxon.seg.metadata`` ... ``.fallback``  the segmented path's stages, in
                                       order: ``metadata``, ``buffer``,
                                       ``upload``, ``demux_queue``,
                                       ``between``, ``summary``, ``chain``,
                                       ``plan_dispatch``, ``fallback``
                                       (``DeviceDecoded.stage_seconds``)
``claxon.seg.results``                 inside ``plan_dispatch``: the
                                       per-stream results loop (the
                                       group's PCM allocation, cut into
                                       views, ``DecodedStream``, output
                                       offsets); no stage of its own
``claxon.walk.extract``                the C++ host walk over the streams
``claxon.walk.plan``                   ``pipeline_bits.plan_raw_bits``
``claxon.walk.dispatch``               the host walk's uploads and launches
``claxon.sync.wait``, ``.crc``         ``sync()``: the kernels, the verdict
``claxon.fetch.start``                 ``start_fetch()``: the landing
                                       (arena, ``interleave_runs``), K3b
                                       pack, pinned buffers, the copies
                                       queued
``claxon.fetch.wait``                  ``to_host()`` waiting for the copies
``claxon.fetch.scatter``               ``to_host()`` cutting the landed
                                       arena into per-stream views, and
                                       the strided copies of any other
                                       bucket into per-stream PCM
``claxon.fetch.crc``                   ``to_host()``'s CRC verdict
``claxon.build``                       loading the kernel library (building
                                       it first if needed), in
                                       :data:`process`
=====================================  =====================================

``claxon.seg.between`` runs from the end of ``begin_segmented`` to the
start of ``finish_segmented`` (the caller's time); it is timed but opens
no profiler range, since it starts and ends in different calls.

Counters: ``upload_group_bytes``, the segmented path's group words
uploaded in ``claxon.seg.upload``; ``upload_staged``, the groups staged
in a CUDA device's pinned buffer, and ``upload_stage_grow``, those of
them that first grew it (none on the CPU); ``fetch_bytes``, the
device-to-host bytes ``start_fetch()`` queued; ``fetch_landed_buckets``,
the buckets it laid out on the card (``interleave_runs``) and copied as
one arena, and ``fetch_scattered_buckets``, those that take
``to_host()``'s host scatter (on the CPU, or split into shards): the
landing's engagement share is landed / (landed + scattered);
``seg_streams``, the streams the segmented path queued on the device
demux (after the streams it sent to the host walk before the demux),
``seg_frames``, the frames it chained, and ``seg_fallback_streams``,
the streams it sent to the host walk, before the demux, on a chain
break or with a group whose sync candidates overflowed (0 when none);
``seg_pcm_allocs``, the PCM allocations it made for its chained streams
(one per group that chained a stream: ``seg_streams / seg_pcm_allocs``
streams share each), and ``seg_pcm_bytes``, their bytes (samples x
channels x 4); on the host walk (``pipeline._decode_walked``; a
segmented batch's fallback streams add theirs) ``walk_streams``, the
streams walked, ``walk_units``, the walk units (a whole stream, or one
chunk of frames of a stream of ``MAX_BATCH_BYTES`` or more),
``walk_frames`` and ``walk_bytes``, the frames and the frame-section
bytes the C++ core walked (``walk_bytes`` over the seconds of
``claxon.walk.extract`` is the walk's rate), and ``walk_runs``, the
runs of units planned and uploaded apart
(``pipeline_bits.decode_raw_bits_device`` calls).
(``DeviceDecoded.upload_bytes`` stays the batch's whole host-to-device
count.)

:func:`recent` gives the records of the last :data:`RECENT` batches
begun in this process, for a caller that keeps no ``DeviceDecoded``: a
benchmark that reads each call's stages after its loop.
"""

import collections
import itertools
import time

import torch.autograd.profiler as _autograd_profiler
from torch._C import _profiler

__all__ = ["Trace", "Stages", "batch", "merged", "recent", "process",
           "RECENT"]

#: the number of batch records :func:`recent` keeps.
RECENT = 1024

_ids = itertools.count(1)
_recent = collections.deque(maxlen=RECENT)


class Trace:
    """One batch's record: ``batch`` (its id), ``spans`` and
    ``counters``."""

    __slots__ = ("batch", "spans", "counters", "_open")

    def __init__(self):
        self.batch = next(_ids)
        self.spans = []
        self.counters = {}
        self._open = []     # names of this record's open spans

    def span(self, name):
        """A context manager that records span ``name``."""
        return _Span(self, name)

    def add(self, name, start_ns, end_ns):
        """Record span ``name`` timed by the caller (no profiler range)."""
        self.spans.append((name, start_ns, end_ns,
                           self._open[-1] if self._open else None,
                           self.batch))

    def count(self, name, n):
        """Add ``n`` to counter ``name``."""
        self.counters[name] = self.counters.get(name, 0) + n

    def seconds(self, name):
        """Seconds of every span named ``name``, summed."""
        return sum(e - s for n, s, e, _p, _b in self.spans
                   if n == name) / 1e9


class _Span:
    __slots__ = ("rec", "name", "parent", "start", "range")

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        opened = self.rec._open
        self.parent = opened[-1] if opened else None
        opened.append(self.name)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        rec = self.rec
        rec._open.pop()
        rec.spans.append((self.name, self.start, end, self.parent,
                          rec.batch))
        return False


class Stages:
    """Named stages of one record, each a span ``prefix + label``:
    ``seconds`` sums each label's spans (``DeviceDecoded.
    stage_seconds``). With ``cpu_marks``, ``marks`` is [("start", t),
    (label, t), ...], ``t`` the process's CPU seconds
    (``time.process_time``) when the batch began and when each stage
    ended; else None."""

    def __init__(self, rec, prefix, cpu_marks=False):
        self.rec = rec
        self.prefix = prefix
        self.seconds = {}
        self.marks = [("start", time.process_time())] if cpu_marks else None

    def __call__(self, label):
        """A context manager that records stage ``label``."""
        return _Stage(self, label)

    def add(self, label, start_ns):
        """Record stage ``label`` from ``start_ns`` to now (no profiler
        range)."""
        self.rec.add(self.prefix + label, start_ns, time.perf_counter_ns())
        self._ended(label)

    def _ended(self, label):
        _n, start, end, _p, _b = self.rec.spans[-1]
        self.seconds[label] = self.seconds.get(label, 0.0) \
            + (end - start) / 1e9
        if self.marks is not None:
            self.marks.append((label, time.process_time()))

    def report(self):
        """With ``marks`` kept, print each stage's host-CPU milliseconds
        (from the previous mark to its own)."""
        if self.marks is not None:
            print("seg stage CPU ms:",
                  [(b, round((t1 - t0) * 1e3, 3)) for (b, t1), (_, t0)
                   in zip(self.marks[1:], self.marks)])


class _Stage:
    __slots__ = ("stages", "label", "span")

    def __init__(self, stages, label):
        self.stages = stages
        self.label = label

    def __enter__(self):
        self.span = self.stages.rec.span(self.stages.prefix + self.label)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        self.stages._ended(self.label)
        return False


def batch():
    """A new batch record, kept among :func:`recent`'s."""
    rec = Trace()
    _recent.append(rec)
    return rec


def merged(records):
    """One record for a result made of several: the record itself when
    they are one, else a new record holding every span (each with its own
    batch id), in start order, and every counter summed."""
    unique = list({id(r): r for r in records}.values())
    if len(unique) == 1:
        return unique[0]
    out = Trace()
    for r in unique:
        out.spans.extend(r.spans)
        for k, v in r.counters.items():
            out.count(k, v)
    out.spans.sort(key=lambda s: s[1])
    return out


def recent():
    """The records of the last :data:`RECENT` batches begun in this
    process (``decode_streams_device`` calls, segmented batches begun
    without a record), oldest first."""
    return list(_recent)


#: the process's own record: ``claxon.build``.
process = Trace()
