"""Spans from the benchmark's own files, and what the traced run reads
from ``torch.profiler``.

A span names a layer boundary that the benchmark can see from outside
the program: the whole call (``batch``), the entry (``decode``), the
wait for the kernels and the CRC verdict (``sync``), the fetch to host
(``fetch``), and, by wrapping the program's module functions for the
traced run only, the segmented path's two halves (``seg_begin``,
``seg_finish``), the C++ host walk (``walk``) and its numpy planning
(``plan``). Each span adds its host seconds to the current call's record
and, under the profiler, opens a ``record_function`` range
``flacbench.<name>`` that labels the device's idle gaps.
"""

import contextlib
import functools
import time

__all__ = ["Spans", "device_events", "host_spans"]

PREFIX = "flacbench."


class Spans:
    def __init__(self, profiling):
        self.profiling = profiling
        self.current = None      # the running call's {name: seconds}
        self._undo = []

    @contextlib.contextmanager
    def span(self, name):
        rf = contextlib.nullcontext()
        if self.profiling:
            import torch

            rf = torch.profiler.record_function(PREFIX + name)
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                if self.current is not None:
                    self.current[name] = self.current.get(name, 0.0) \
                        + time.perf_counter() - t0

    def wrap(self, module, attr, name):
        """Put a span around ``module.attr`` until :meth:`restore`."""
        fn = getattr(module, attr)

        @functools.wraps(fn)
        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        setattr(module, attr, spanned)
        self._undo.append((module, attr, fn))

    def wrap_program(self):
        """Spans inside the program's host layers (traced runs only)."""
        from claxon_tpu_torch import native, pipeline_bits, pipeline_seg

        self.wrap(native, "extract_stream_bits", "walk")
        self.wrap(native, "extract_frames_bits", "walk")
        self.wrap(pipeline_bits, "plan_raw_bits", "plan")
        self.wrap(pipeline_seg, "begin_segmented", "seg_begin")
        self.wrap(pipeline_seg, "finish_segmented", "seg_finish")

    def restore(self):
        while self._undo:
            module, attr, fn = self._undo.pop()
            setattr(module, attr, fn)


def _times(ev):
    if hasattr(ev, "start_ns"):
        start = ev.start_ns() / 1e9
        return start, start + ev.duration_ns() / 1e9
    start = ev.start_us() / 1e6
    return start, start + ev.duration_us() / 1e6


def _raw_events(prof):
    return prof.profiler.kineto_results.events()


def device_events(prof):
    """[(name, kind, start_s, end_s), ...] of every operation that ran on
    a CUDA device: kind "copy" for memcpy and memset, else "kernel". The
    profiler's mirrors of the benchmark's ranges on the device timeline
    are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in _raw_events(prof):
        if ev.device_type() != cuda:
            continue
        name = ev.name()
        if name.startswith(PREFIX):
            continue
        kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
        out.append((name, kind, *_times(ev)))
    return out


def host_spans(prof):
    """[(name, start_s, end_s), ...] of the benchmark's ranges on the
    host, their prefix dropped."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    out = []
    for ev in _raw_events(prof):
        name = ev.name()
        if ev.device_type() == cpu and name.startswith(PREFIX):
            out.append((name[len(PREFIX):], *_times(ev)))
    return out
