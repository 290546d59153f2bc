"""BENCHMARK.json against the contract's shape, and every entry finding
its files by name under portbench/."""
import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _load(path: Path):
    spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 << 10


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_finds_its_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and ONE_LINE.match(cfg["source"])
    assert ONE_LINE.match(cfg["why"])
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("portbench/")
    body = json.loads(path.read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert all(NAME.match(k) and k in body for k in cfg["reduced"])
    assert (PB / "generators" / f"{body['data']['generator']}.py").is_file()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_files_and_reports_enough(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert ONE_LINE.match(cell["why"]) and cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    mix = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    for folder, name in (("entries", mix["entry"]), ("loops", mix["loop"]),
                         ("requests", mix["requests"]["kind"])):
        assert (PB / folder / f"{name}.py").is_file(), (folder, name)
    entry = _load(PB / "entries" / f"{mix['entry']}.py")
    assert entry.JUDGED_AS in ("compress", "decode")
    for part in ("prepare", "argument", "bytes_in", "Program", "Control",
                 "half"):
        assert hasattr(entry, part), part
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", []) or (
        "workloads" not in m and m["moves"] in e2e)
        for m in BENCH["per_layer"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_finds_its_reader(m):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in BENCH["end_to_end"]:
        allowed |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert ONE_LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for w in m["workloads"]:
            reported = [e["name"] for e in BENCH["end_to_end"]
                        if w in e.get("workloads", [w])]
            assert m["moves"] in reported
    assert set(m) <= allowed and NAME.match(m["name"])
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert set(m.get("workloads", [])) <= {w["name"]
                                           for w in BENCH["workloads"]}
    assert callable(_load(PB / "metrics" / f"{m['name']}.py").read)


def test_names_unique_and_four_chip_share():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_check_fits_in_its_time():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
