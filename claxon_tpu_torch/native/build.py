"""Build the port's C++ host core: ``python -m claxon_tpu_torch.native.build``.

Compiles ``src/claxon_demux.cpp`` (a verbatim copy of the JAX package's
core) to ``libclaxon_demux.so`` next to this file with g++. The binding
builds it on first use when the .so is missing or older than the source
(``CLAXON_TPU_NO_BUILD=1`` turns that off: an existing library loads, a
missing one leaves the core unavailable).

``--ubsan`` builds ``libclaxon_demux_ubsan.so`` with -fsanitize=undefined,
aborting on any undefined behaviour; ``CLAXON_TPU_UBSAN=1`` has the
binding load (and build) that library instead, to run the tests or a
fuzzer with every C++ operation checked.
"""

import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "src" / "claxon_demux.cpp"
LIB = HERE / "libclaxon_demux.so"
LIB_UBSAN = HERE / "libclaxon_demux_ubsan.so"


def build(verbose=True, ubsan=False):
    """Compile the shared library (with ``ubsan``, the sanitizer-checked
    one); returns the path or raises."""
    if ubsan:
        flag_sets = [
            ["-O1", "-std=c++17", "-fPIC", "-shared", "-g",
             "-fsanitize=undefined", "-fno-sanitize-recover=all"],
        ]
    else:
        flag_sets = [
            ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
             "-funroll-loops"],
            ["-O3", "-std=c++17", "-fPIC", "-shared"],  # fallback: portable
        ]
    out = LIB_UBSAN if ubsan else LIB
    # Compile to a per-process temp file and atomically rename: concurrent
    # builders never expose a half-written .so, and a process that already
    # dlopen'ed the old file keeps its mapping (the inode lives on).
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
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
                os.replace(tmp, out)
                if verbose:
                    print(f"built {out}", file=sys.stderr)
                return out
            last_err = proc.stderr
    finally:
        if tmp.exists():
            tmp.unlink()
    raise RuntimeError(f"g++ failed to build {SRC}:\n{last_err}")


def ensure_built():
    """Build if missing or stale; returns the lib path or None on failure.
    ``CLAXON_TPU_UBSAN`` selects the sanitizer-checked library, and
    ``CLAXON_TPU_NO_BUILD`` returns the library only if it exists."""
    ubsan = bool(os.environ.get("CLAXON_TPU_UBSAN"))
    lib = LIB_UBSAN if ubsan else LIB
    if os.environ.get("CLAXON_TPU_NO_BUILD"):
        return lib if lib.exists() else None
    try:
        stale = (not lib.exists() or
                 (SRC.exists() and lib.stat().st_mtime < SRC.stat().st_mtime))
    except OSError:
        stale = not lib.exists()
    if not stale:
        return lib
    try:
        build(verbose=False, ubsan=ubsan)
        return lib
    except Exception as e:
        # A working (if stale) library beats none; the binding's ABI gate
        # rejects it if its layouts drifted.
        if lib.exists():
            print(f"claxon_tpu_torch: rebuild of {lib.name} failed ({e}); "
                  "using the existing library", file=sys.stderr)
            return lib
        return None


if __name__ == "__main__":
    build(ubsan="--ubsan" in sys.argv)
