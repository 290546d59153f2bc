"""The four-card cell `l6-sharded-4card` driven through the harness on four
CPU shards (`["cpu"] * 4`), at a cut size of four 128 KiB lanes (one per
shard): the result line with trace 0 and 1, every metric it reports above
0, the sharded path's metrics read from its spans, and the control and
the fault `half` in the program's place coming out not correct."""
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import control, harness  # noqa: E402

BENCH = harness.load_benchmark()
CELL = "l6-sharded-4card"
LANE = 131072
CUT = 4 * LANE
SHARDED = {"sharded.stage1_ms_per_MiB", "sharded.trees_ms_per_MiB",
           "sharded.stage2_ms_per_MiB", "sharded.card_concurrency",
           "frame.ms_per_MiB", "stitch.ms_per_MiB", "compress.syncs_per_MiB"}
_make = harness.make_data


def _cut(monkeypatch):
    """Every run of the test cuts its data to the first CUT bytes."""
    monkeypatch.setattr(harness, "make_data",
                        lambda config, seed: _make(config, seed)[:CUT])


def test_cell_is_four_cards_of_pigz_lanes():
    parts = harness.cell_parts(BENCH, CELL)
    assert parts["cell"]["chips"] == 4
    assert parts["config"]["codec"]["lane_block"] == LANE
    assert parts["config"]["codec"]["level"] == 6
    assert len(harness.make_data(parts["config"], 2**31 + 5)) == 35_651_584


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_four_cpu_shards(monkeypatch, trace):
    _cut(monkeypatch)
    result = harness.run_cell(CELL, 2**31 + 4242, 0.05, bool(trace),
                              time.perf_counter(), device="cpu",
                              log=lambda s: None)
    line = json.loads(json.dumps(result))
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["count"] == 4
    parts = harness.cell_parts(BENCH, CELL)
    names = {m["name"] for m in
             (parts["per_layer"] if trace else parts["end_to_end"])}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert m["value"] > 0
    if trace:
        # the program's spans and counters; the device's metrics need a card
        assert set(line["metrics"]) == SHARDED
    else:
        assert set(line["metrics"]) == {"compress_MBps", "setup_s"}


def test_expected_launches_one_per_shard():
    from portbench.loadgen import module
    entry = module("entries", "compress_multichip")
    codec = harness.cell_parts(BENCH, CELL)["config"]["codec"]
    got = entry.expected_launches(codec, [(0, 35_651_584), (0, 5 * LANE)])
    assert got["k1"] == [(68, 32768 + LANE, False)] * 4 \
        + [(2, 32768 + LANE, False)] * 4
    assert got["k2"] == [(68, 32768 + LANE)] * 4 + [(2, 32768 + LANE)] * 4


@pytest.mark.parametrize("side", ["control", "half"])
def test_check_fails(monkeypatch, side):
    _cut(monkeypatch)
    (result,) = control.run(CELL, [2**32 + 99], 0.05, side, device="cpu",
                            log=lambda s: None)
    assert result["correct"] is False
    checks = result["checks"]
    if side == "control":
        # the control's streams decode: only their size gives them away
        assert checks["wrong_answers"]["value"] == 0
        assert checks["size_excess_pct"]["value"] \
            > checks["size_excess_pct"]["limit"]
    else:
        assert checks["wrong_answers"]["value"] >= 1
