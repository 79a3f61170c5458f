"""Build and load the port's hand-written CUDA kernels.

The kernels live in ``claxon_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use they are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library under ``build/claxon_tpu_torch/`` at the
repository root, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the cached library. The
library is bound with ``ctypes``: every pointer and the CUDA stream cross
as ``c_void_p``, every size as ``c_int64``, and every entry point returns
its ``cudaGetLastError()``, which :func:`check` turns into an exception.

A failed build raises; nothing falls back to the plain PyTorch forms.
Nothing here runs at import time (the CPU test suite imports every
module on a host without ``nvcc``).
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess

__all__ = ["load", "check", "stream_handle"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("synth.cu", "entropy.cu", "entropy_delta.cu",
            "entropy_delta_parent.cu", "crc.cu", "segment.cu", "seg_parse.cu",
            "demux.cu", "seg_gather.cu", "pack16.cu", "crc_lanes.cu",
            "crc_lanes_parent.cu", "rice.cu", "rice_parent.cu")
#: headers the sources include (hashed with them).
_HEADERS = ("scan.cuh", "header.cuh", "shifts.cuh")
_BUILD_DIR = _PKG.parent / "build" / "claxon_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = _ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_N = ctypes.c_int64

#: C entry point -> argument types (see the csrc files for their meaning).
_SIGNATURES = {
    # x, coefs, shifts, orders, lengths, out, L, T, stream
    "cxk_synthesize": [_P, _P, _P, _P, _P, _P, _N, _N, _P],
    # x, coefs, shifts, orders, lengths, wasted, pair_modes, out, L, T,
    # stream
    "cxk_synthesize_epilogue": [_P, _P, _P, _P, _P, _P, _P, _P, _N, _N, _P],
    # stream, W, bases, ks, KP, P, ps, orders, pbits, flags, warm, WM,
    # lengths, out, L, NC, SA, stream
    "cxk_entropy_stream": [_P, _N, _P, _P, _N, _N, _P, _P, _P, _P, _P, _N,
                           _P, _P, _N, _N, _N, _P],
    # K9 -- slots, deltas, ks, KP, P, ps, orders, pbits, vflags, warm, WM,
    # out, L, NC, SA, stream
    "cxk_entropy_delta_slots": [_P, _P, _P, _N, _N, _P, _P, _P, _P, _P, _N,
                                _P, _N, _N, _N, _P],
    # K10 -- stream, W, bases, deltas, ks, KP, P, ps, orders, pbits, flags,
    # warm, WM, lengths, out, L, NC, SA, stream
    "cxk_entropy_delta_stream": [_P, _N, _P, _P, _P, _N, _N, _P, _P, _P, _P,
                                 _P, _N, _P, _P, _N, _N, _N, _P],
    # K9's and K10's parent kernels (timing only), the same arguments
    "cxk_entropy_delta_slots_parent": [_P, _P, _P, _N, _N, _P, _P, _P, _P,
                                       _P, _N, _P, _N, _N, _N, _P],
    "cxk_entropy_delta_stream_parent": [_P, _N, _P, _P, _P, _N, _N, _P, _P,
                                        _P, _P, _P, _N, _P, _P, _N, _N, _N,
                                        _P],
    # stream, W, starts, ends, out, F, tables, item_off, stream
    "cxk_crc16_ranges": [_P, _N, _P, _P, _P, _N, _P, _P, _P],
    # K5 -- W -> number of scan blocks; stream, W, n_bytes, blk, stream;
    # stream, W, n_bytes, incl, positions, C, stream; stream, W, n_bytes,
    # count, positions, valid, win, C, stream
    "cxk_sync_blocks": [_N],
    "cxk_sync_count": [_P, _N, _N, _P, _P],
    "cxk_sync_write": [_P, _N, _N, _P, _P, _N, _P],
    "cxk_header_check": [_P, _N, _N, _P, _P, _P, _P, _N, _P],
    # K6 -- in, out, W, stream; positions, valid, win, C, ends, si_bps, S,
    # T, nch, fields, stream; positions, fields, C, count, wcap, lane_of,
    # start_bits, bs, modes, bps, counts, stream; positions, fields,
    # lane_of, C, end_bits, walk_ok, n_parts, sa_words, nch, summary,
    # stream
    "cxk_seg_bswap": [_P, _P, _N, _P],
    "cxk_seg_fields": [_P, _P, _P, _N, _P, _P, _N, _N, _N, _P, _P],
    "cxk_seg_compact": [_P, _P, _N, _P, _N, _P, _P, _P, _P, _P, _P, _P],
    "cxk_seg_summary": [_P, _P, _P, _N, _P, _P, _P, _P, _N, _P, _P],
    # K5 + K6 fused front -- W -> scratch ints; words_le, W, n_bytes,
    # ends, si_bps, S, T, nch, C, wcap, stream, positions, valid, win,
    # fields, lane_of, start_bits, bs, modes, bps, counts, scratch, stream
    "cxk_front_scratch": [_N],
    "cxk_demux_front": [_P, _N, _N, _P, _P, _N, _N, _N, _N, _N]
                       + [_P] * 13,
    # K7 -- stream, W, start_bits, bs, modes, bps0, F, T, nch, then the
    # 13 per-lane outputs (demux.WALK_KEYS order), deltas (or null),
    # end_bits, ok, the scratch state and desc, stream
    "cxk_walk_frames": [_P, _N, _P, _P, _P, _P, _N, _N, _N] + [_P] * 14
                       + [_P] * 5,
    # K8 -- values, warm, order, rows, R, row_words, L, Tb32, out, stream
    "cxk_seg_gather": [_P, _P, _P, _P, _N, _N, _N, _N, _P, _P],
    # K3b -- x, L, T, per_lane, words, flag, stream; words, n_words, out,
    # stream
    "cxk_pack_int16_pairs": [_P, _N, _N, _N, _P, _P, _P],
    "cxk_unpack_int16_pairs": [_P, _N, _P, _P],
    # crc16_device -- data, L, B, lengths, tables, out, stream;
    # crc16_frames_device -- stream, S, starts, ends, F, n_words, tables,
    # out, stream
    "cxk_crc16_rows": [_P, _N, _N, _P, _P, _P, _P],
    "cxk_crc16_windows": [_P, _N, _P, _P, _N, _N, _P, _P, _P],
    # rice_decode -- words, W, start_bits, params, counts, L, T, out,
    # end_bits, flag, stream
    "cxk_rice_decode": [_P, _N, _P, _P, _P, _N, _N, _P, _P, _P, _P],
    # the two kernels' parents (timing only), the same arguments
    "cxk_crc16_windows_parent": [_P, _N, _P, _P, _N, _N, _P, _P, _P],
    "cxk_rice_decode_parent": [_P, _N, _P, _P, _P, _N, _N, _P, _P, _P, _P],
}

#: entry points that return a value rather than a CUDA error code.
_VALUED = {"cxk_sync_blocks": ctypes.c_int64,
           "cxk_front_scratch": ctypes.c_int64}

_lib = None


def _nvcc():
    # torch's lookup: $CUDA_HOME / $CUDA_PATH, then nvcc on PATH, then
    # the toolkit's default install directory.
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = pathlib.Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("claxon_tpu_torch: nvcc not found (set "
                           "CUDA_HOME); the CUDA kernels cannot be built")
    return str(nvcc)


def _library_path():
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libclaxon_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with the first failure's
    output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        try:
            _out, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            _out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = " ".join(cmd) + "\n" + err
    if failed is not None:
        raise RuntimeError("claxon_tpu_torch: nvcc failed:\n" + failed)


def _build(out):
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to per-process names and rename: another process never
    # sees a half-written library.
    tag = f"tmp{os.getpid()}"
    tmp = out.with_suffix(f".{tag}.so")
    objs = [_BUILD_DIR / f"{out.stem}.{name}.{tag}.o" for name in _SOURCES]
    nvcc = _nvcc()
    try:
        _run_all([[nvcc, *_FLAGS, "-c", "-o", str(obj), str(_CSRC / name)]
                  for name, obj in zip(_SOURCES, objs)])
        _run_all([[nvcc, *_ARCH, "-shared", "-o", str(tmp),
                   *(str(o) for o in objs)]])
        os.replace(tmp, out)
    finally:
        for f in [tmp, *objs]:
            if f.exists():
                f.unlink()


def load():
    """The loaded kernel library, building it first if needed; the span
    ``claxon.build`` of the process's record (``trace.process``)."""
    global _lib
    if _lib is not None:
        return _lib
    from .. import trace

    with trace.process.span("claxon.build"):
        path = _library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _VALUED.get(name, ctypes.c_int)
    _lib = lib
    return lib


def check(err, name):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"claxon_tpu_torch: {name} launch failed with "
                           f"CUDA error {err}")


def stream_handle(device):
    """The raw handle of PyTorch's current CUDA stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
