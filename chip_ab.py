#!/usr/bin/env python3
"""Alternating timing of two trees of the port on one NVIDIA card.

    python3 chip_ab.py --level 9 --pairs 10 PARENT_DIR CHANGE_DIR

Times warm compress_cuda calls of chip_smoke.py's 8.5 MiB corpus at one
level, for the zlibng_tpu_torch package of each tree. Each run is its own
process (its own allocator and kernel build), and the runs go in ABBA
order, P C C P P C ..., so that a drift of the card or the host falls on
both trees alike. Each run prints its cold and warm seconds and warm
stage split; the end prints each tree's median and range and, as its
last line, one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def child(tree: str, level: int, reps: int) -> None:
    """One run: build the tree's kernels, one cold call, then `reps` warm
    calls; prints one JSON line."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    data, _ = chip_smoke.corpus()
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from zlibng_tpu_torch import _build, compress_cuda
    from zlibng_tpu_torch.ops import deflate
    _build.build()
    t0 = time.perf_counter()
    out = compress_cuda(data, level)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    warm, stages = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        if compress_cuda(data, level) != out:
            raise AssertionError("warm run differs from cold run")
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        stages.append(dict(deflate.stage_seconds))
    print(json.dumps(dict(size=len(out), cold=cold, warm=warm,
                          stages=stages)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--level", type=int, default=9)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2,
                    help="warm calls per run")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*")
    a = ap.parse_args()
    if a.child:
        child(a.child, a.level, a.reps)
        return 0
    if len(a.trees) != 2:
        ap.error("give two tree directories: PARENT CHANGE")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    order = []
    for i in range(a.pairs):
        order += ["P", "C"] if i % 2 == 0 else ["C", "P"]
    runs = {"P": [], "C": []}
    for i, t in enumerate(order):
        tree = a.trees[0] if t == "P" else a.trees[1]
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", tree,
             "--level", str(a.level), "--reps", str(a.reps)],
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i + 1} ({t}) failed: rc "
                             f"{res.returncode}")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        runs[t].append(r)
        st = r["stages"][-1]
        print(f"run {i + 1} {t}: {r['size']} B; cold {r['cold']:.3f} s; "
              f"warm " + ", ".join(f"{w:.3f}" for w in r["warm"])
              + f" s; last warm stages: stage1 {st['stage1']:.3f}, stage2 "
              f"{st['stage2']:.3f}, stitch {st['stitch']:.3f} s", flush=True)
    sizes = {r["size"] for rs in runs.values() for r in rs}
    if len(sizes) != 1:
        raise SystemExit(f"the trees' streams differ in size: {sizes}")
    for t, rs in runs.items():
        w = [min(r["warm"]) for r in rs]
        print(f"{t} L{a.level}: best warm of each run, median "
              f"{statistics.median(w):.3f} s, range {min(w):.3f}-"
              f"{max(w):.3f} s over {len(w)} runs", flush=True)
    print(json.dumps(dict(level=a.level, order=order, runs=runs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
