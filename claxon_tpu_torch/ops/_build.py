"""Build and load the port's hand-written CUDA kernels.

The kernels live in ``claxon_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use they are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library under ``build/claxon_tpu_torch/`` at
the repository root, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached library. The
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
import time

__all__ = ["load", "check", "stream_handle", "build_seconds"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("synth.cu", "entropy.cu", "crc.cu")
_BUILD_DIR = _PKG.parent / "build" / "claxon_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_N = ctypes.c_int64

#: C entry point -> argument types (see the csrc files for their meaning).
_SIGNATURES = {
    # x, coefs, shifts, orders, lengths, out, L, T, stream
    "cxk_synthesize": [_P, _P, _P, _P, _P, _P, _N, _N, _P],
    # stream, W, bases, ks, KP, P, ps, orders, pbits, flags, warm, WM,
    # lengths, out, L, NC, SA, stream
    "cxk_entropy_stream": [_P, _N, _P, _P, _N, _N, _P, _P, _P, _P, _P, _N,
                           _P, _P, _N, _N, _N, _P],
    # stream, W, starts, ends, out, F, stream
    "cxk_crc16_ranges": [_P, _N, _P, _P, _P, _N, _P],
}

_lib = None
#: wall-clock seconds the last build (or cache hit) of this process took.
build_seconds = None


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
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libclaxon_kernels_{h.hexdigest()[:16]}.so"


def _build(out):
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a per-process name and rename: a concurrent builder never
    # sees a half-written library.
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp),
           *(str(_CSRC / name) for name in _SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError("claxon_tpu_torch: nvcc failed:\n" +
                               " ".join(cmd) + "\n" + proc.stderr)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def load():
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    path = _library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
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
