"""Build the port's C++ host core: ``python -m claxon_tpu_torch.native.build``.

Compiles ``src/claxon_demux.cpp`` (a verbatim copy of the JAX package's
core) to ``libclaxon_demux.so`` next to this file with g++. The binding
builds it on first use when the .so is missing or older than the source.
"""

import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "src" / "claxon_demux.cpp"
LIB = HERE / "libclaxon_demux.so"


def build(verbose=True):
    """Compile the shared library; returns the path or raises."""
    flag_sets = [
        ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
         "-funroll-loops"],
        ["-O3", "-std=c++17", "-fPIC", "-shared"],  # fallback: portable
    ]
    # Compile to a per-process temp file and atomically rename: concurrent
    # builders never expose a half-written .so, and a process that already
    # dlopen'ed the old file keeps its mapping (the inode lives on).
    tmp = LIB.with_suffix(f".tmp{os.getpid()}.so")
    last_err = None
    try:
        for flags in flag_sets:
            cmd = ["g++", *flags, str(SRC), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                last_err = str(e)
                continue
            if proc.returncode == 0:
                os.replace(tmp, LIB)
                if verbose:
                    print(f"built {LIB}", file=sys.stderr)
                return LIB
            last_err = proc.stderr
    finally:
        if tmp.exists():
            tmp.unlink()
    raise RuntimeError(f"g++ failed to build {SRC}:\n{last_err}")


def ensure_built():
    """Build if missing or stale; returns the lib path or None on failure."""
    try:
        stale = (not LIB.exists() or
                 (SRC.exists() and LIB.stat().st_mtime < SRC.stat().st_mtime))
    except OSError:
        stale = not LIB.exists()
    if not stale:
        return LIB
    try:
        build(verbose=False)
        return LIB
    except Exception as e:
        # A working (if stale) library beats none; the binding's ABI gate
        # rejects it if its layouts drifted.
        if LIB.exists():
            print(f"claxon_tpu_torch: rebuild of {LIB.name} failed ({e}); "
                  "using the existing library", file=sys.stderr)
            return LIB
        return None


if __name__ == "__main__":
    build()
