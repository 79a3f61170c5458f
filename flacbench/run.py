"""Run one cell of the benchmark once and print its result line.

    python3 flacbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with one CUDA card. The cells, their
configurations and traffic mixes, and the metrics each one reports are
in ``BENCHMARK.json`` (see ``flacbench/harness.py``). The last line on
standard output is one JSON object; the numbers compared against the
plain reference, each with its limit, are the last lines on standard
error and the ``compared`` key of that object. Without a card the run
exits with code 2 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Caches of kernel builders stay in the checkout, at fixed paths (the
    # port's own build directories, build/ and its native library, are
    # there already).
    cache = ROOT / "build" / "flacbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    from flacbench.harness import (Bench, card_line, forbidden_modules, log,
                                   run_cell)

    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, compared = run_cell(bench, args.workload, args.seed,
                                args.seconds, args.trace, device="cuda",
                                t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return 3
    log(f"card: {card_line()}")
    for name, value, limit in compared:
        print(f"compared {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
