"""One run of one cell: set-up, the measured window, the traced part, the
judgement and the result line. Everything that belongs to one
configuration, traffic mix or metric is found by its name in
BENCHMARK.json: `portbench/configs/<config>.json` (through the entry's
`file`), `portbench/traffic/<traffic>.json`, the files the mix names
(`entries/`, `requests/`, `loops/`; see `loadgen.py`),
`portbench/generators/<generator>.py` and `portbench/metrics/<metric>.py`.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

from . import devtrace, geometry, reference
from .loadgen import Plan, module

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_parts(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix and metric entries."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    reports = {m["name"] for m in bench["end_to_end"]
               if workload in m.get("workloads", [workload])}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in reports)]
    end_to_end = [m for m in bench["end_to_end"] if m["name"] in reports]
    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=end_to_end, per_layer=per_layer)


def make_data(config: dict, seed: int) -> bytes:
    gen = config["data"]
    return module("generators", gen["generator"]).make(
        seed, **gen.get("params", {}))


def sender(plan: Plan, program):
    """send(req) -> the request's record: the answer (or the error) and
    what the program read out after the call."""
    def send(req):
        try:
            out, err = program(plan.argument(req)), None
        except Exception as e:            # a failed request, counted
            out, err = None, repr(e)
        rec = dict(req=req, out=out, err=err, bytes_in=plan.bytes_in(req),
                   bytes_out=len(out) if out is not None else 0)
        rec.update(program.readings())
        return rec
    return send


def judge(plan: Plan, config: dict, recs: list) -> dict:
    """The reference's verdict on every answer: the numbers compared,
    each with its limit."""
    answers = [(r["req"], plan.expected(r["req"]), r["out"])
               for r in recs if r["out"] is not None]
    return reference.judge(plan.entry.JUDGED_AS, plan.codec,
                           config.get("checks", {}), answers,
                           len(recs) - len(answers))


def traced(plan: Plan, program, cuda_indices: list) -> tuple[list, dict]:
    """The bounded traced part after the window: `profile_calls` more
    requests under the profiler, with the launch counters read around."""
    send = sender(plan, program)
    it = plan.requests()
    reqs = [next(it) for _ in range(plan.profile_calls)]
    before = program.launches()
    done, summary = devtrace.run([lambda r=r: send(r) for r in reqs],
                                 cuda_indices)
    after = program.launches()
    recs = []
    for rec, _, sec in done:           # send() catches its own errors
        rec["s"] = sec
        recs.append(rec)
    expect = getattr(plan.entry, "expected_launches", None)
    summary.update(
        counted={k: after[k] - before[k] for k in after},
        expected=expect(plan.codec, reqs) if expect else {},
        bytes_in=sum(r["bytes_in"] for r in recs),
        bytes_out=sum(r["bytes_out"] for r in recs))
    return recs, summary


def device_list(chips: int, device: str) -> list:
    """The cell's devices: cuda:0..chips-1, or `device` chips times."""
    if device == "cuda":
        return [f"cuda:{i}" for i in range(chips)]
    return [device] * chips


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda", side=None,
             overrides: dict | None = None, bench: dict | None = None,
             log=None) -> dict:
    """One run of `workload`; returns the result line as a dict. `device`
    "cpu" serves the tests; `side(entry, devices, codec)`, when given,
    makes what stands in the program's place (a control or a faulty
    program, `control.py`); `overrides` replaces keys of the
    configuration ("config") and the mix ("traffic")."""
    import torch
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench = bench or load_benchmark()
    parts = cell_parts(bench, workload)
    cfg, tr = parts["config"], parts["traffic"]
    for key, part in (("config", cfg), ("traffic", tr)):
        for k, v in (overrides or {}).get(key, {}).items():
            part[k] = v
    chips = parts["cell"]["chips"]
    devices = device_list(chips, device)
    cuda_indices = list(range(chips)) if device == "cuda" else []

    data = make_data(cfg, seed)
    plan = Plan(tr, cfg, data, seed)
    log(f"portbench {workload} seed {seed}: {len(data)} B; "
        + plan.describe())
    make = side or (lambda entry, devs, codec: entry.Program(devs, codec))
    program = make(plan.entry, devices, plan.codec)
    for req in plan.warmup():          # builds the kernels on a first run
        program(plan.argument(req))
    for i in cuda_indices:
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)
    setup_s = time.perf_counter() - t_process

    recs, window_s = plan.loop.drive(sender(plan, program), plan.requests(),
                                     seconds)
    summary, prof_recs = None, []
    if trace:
        prof_recs, summary = traced(plan, program, cuda_indices)
    peak = max((torch.cuda.max_memory_allocated(i) for i in cuda_indices),
               default=None)
    del program
    if cuda_indices:
        torch.cuda.empty_cache()

    checks = judge(plan, cfg, recs + prof_recs)
    failed = checks["wrong_answers"]["value"] \
        + checks["failed_calls"]["value"]
    correct = bool(recs) and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    codec = dict(plan.codec, quick=geometry.quick(
        plan.codec["level"], plan.codec.get("strategy", 0)))
    rec = dict(setup_s=setup_s, window_s=window_s,
               judged_as=plan.entry.JUDGED_AS, codec=codec,
               calls=[{k: r[k] for k in r if k not in ("out", "req")}
                      for r in recs],
               profile=summary)
    metrics = {}
    for m in parts["per_layer"] if trace else parts["end_to_end"]:
        value = module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(platform="gpu" if cuda_indices else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda_indices else "cpu",
               count=chips, memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=len(recs), failed=failed,
                  metrics=metrics, device=dev)
    if trace:
        dev.update(busy_s=summary.get("busy_s", 0.0),
                   window_s=summary.get("window_s", 0.0))
        result["breakdown"] = dict(
            device_ops=summary.get("device_ops", []),
            idle_gaps=summary.get("idle_gaps", []))
    result["checks"] = checks
    log(f"portbench {workload}: setup {setup_s:.3f} s, window "
        f"{window_s:.3f} s, {len(recs)} requests, "
        + ", ".join(f"{k} {v['value']:.6g} {v['unit']}"
                    for k, v in metrics.items()))
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return result
