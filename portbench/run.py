#!/usr/bin/env python3
"""Runs one cell of the benchmark of zlibng_tpu_torch once, on the cards
of the machine it is started on:

    python3 portbench/run.py --workload l6-bulk --seed 7 --seconds 30 --trace 0

Prints progress and, as its last lines on standard error, each number the
correctness check compared beside its limit; as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, with --trace 1 breakdown, and last the checks. Exits non-zero with
no result line when CUDA is not available or has fewer cards than the
cell asks for, when the program cannot be imported, and when JAX or the
JAX package is loaded once the window has closed.
"""
import os
import sys
import time


def _process_start() -> float:
    """perf_counter() at this process's start (Linux), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - start_ticks / os.sysconf("SC_CLK_TCK"))
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_PROCESS = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# import the benchmark as the package `portbench` from the checkout's
# root, not its files from the script's folder
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "portbench"]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "zlibng_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    bench = harness.load_benchmark(ROOT)
    chips = harness.cell_parts(bench, args.workload, ROOT)["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_PROCESS, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
