"""Dry runs on the CPU: every cell driven through the harness at a small
size (the look for a card skipped), and the command itself refusing to
run without a card or without the program."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import harness  # noqa: E402
from small import SMALL, cut_data  # noqa: E402

BENCH = harness.load_benchmark()
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_dry_run_line_has_the_contracts_keys(monkeypatch, workload, trace):
    cut_data(monkeypatch)
    result = harness.run_cell(workload, 2**31 + 12345, 0.05, bool(trace),
                              time.perf_counter(), device="cpu",
                              overrides=SMALL[workload], log=lambda s: None)
    line = json.loads(json.dumps(result))
    want = CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    parts = harness.cell_parts(BENCH, workload)
    names = {m["name"] for m in
             (parts["per_layer"] if trace else parts["end_to_end"])}
    assert set(line["metrics"]) <= names
    if not trace:
        # host-clock metrics exist on the CPU too
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_same_seed_same_requests_and_warmup():
    from portbench.loadgen import Plan
    parts = harness.cell_parts(BENCH, "l6-bulk")
    data = bytes(range(256)) * 4_000
    plans = [Plan(parts["traffic"], parts["config"], data, 2**33 + 7)
             for _ in range(2)]
    a, b = ([next(it) for _ in range(20)]
            for it in (p.requests() for p in plans))
    assert a == b == [(0, len(data))] * 20
    assert plans[0].warmup() == [(0, len(data))]
    assert plans[0].entry.JUDGED_AS == "compress"


def test_traffic_names_its_entry_and_loop():
    from portbench.loadgen import Plan
    parts = harness.cell_parts(BENCH, "l6-indexed-decode")
    data = bytes(range(256)) * 4_000
    plan = Plan(dict(parts["traffic"], segment=1 << 14), parts["config"],
                data, 3)
    blob, comp, out = plan.argument(next(plan.requests()))
    assert plan.entry.JUDGED_AS == "decode" and out[-1] == len(data)
    assert plan.bytes_in((0, len(data))) == len(blob)
    assert plan.loop.drive.__module__.endswith("closed")


def _command(cwd: Path):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "l6-bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
