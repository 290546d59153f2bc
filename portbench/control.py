#!/usr/bin/env python3
"""The readings a correctness limit is set from: the program, the control
and the faults, each run through the cell at its own size.

    python3 portbench/control.py --workload l6-bulk --side control --seeds 1 2 3
    python3 portbench/control.py --workload l6-bulk --side program --seeds 1 2 3
    python3 portbench/control.py --workload l6-bulk --side altered --seeds 1

`--side control` puts the control in the program's place: the plain
reference with less than the configuration states (each entry's
`Control`, `reference.control_compress`, `reference.control_decode`).
`--side program` runs the program itself, for the sound readings of many
seeds in one process. `altered` (one byte of every answer flipped where
it is produced) and `half` (half of each request's work left out) plant a
fault under the program's timed path. Each seed runs one short window
(`--seconds`) on the card of the machine; the command prints the checks
of every seed as one JSON line. The benchmark's own runs run none of
this. `--device cpu` runs it on the CPU (the tests do, at small sizes).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != ROOT / "portbench"]
    sys.path.insert(0, str(ROOT))

FAULTS = ("altered", "half")
SIDES = ("program", "control") + FAULTS


def _flip(b: bytes) -> bytes:
    i = len(b) // 2
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


class Faulty:
    """The program with one fault planted under the timed path."""

    def __init__(self, entry, program, fault: str):
        self.entry, self.program, self.fault = entry, program, fault

    def __call__(self, arg):
        if self.fault == "half":
            return self.entry.half(self.program, arg)
        return _flip(self.program(arg))

    def readings(self):
        return self.program.readings()

    def launches(self):
        return self.program.launches()


def side_maker(side: str):
    """What `harness.run_cell` puts in the program's place for `side`."""
    if side not in SIDES:
        raise ValueError(f"unknown side {side}")
    if side == "program":
        return None
    if side == "control":
        return lambda entry, devices, codec: entry.Control(devices, codec)
    return lambda entry, devices, codec: Faulty(
        entry, entry.Program(devices, codec), side)


def run(workload: str, seeds: list, seconds: float, side: str,
        device: str = "cuda", overrides: dict | None = None,
        log=None) -> list:
    """Each seed's result line with `side` in the program's place."""
    from portbench import harness
    bench = harness.load_benchmark()
    return [harness.run_cell(workload, s, seconds, False,
                             time.perf_counter(), device=device,
                             side=side_maker(side), overrides=overrides,
                             bench=bench, log=log) for s in seeds]


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--side", choices=SIDES, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    results = run(args.workload, args.seeds, args.seconds, args.side,
                  args.device)
    summary = [dict(seed=s, correct=r["correct"], attempted=r["attempted"],
                    checks=r["checks"])
               for s, r in zip(args.seeds, results)]
    print(json.dumps(dict(workload=args.workload, side=args.side,
                          runs=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
