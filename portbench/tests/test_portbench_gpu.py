"""On a card: the command runs a short cell and the control fails there.
Skips without one (decided inside each test).

    python -m pytest -m gpu portbench/tests/test_portbench_gpu.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(*args):
    return subprocess.run([sys.executable, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", ["0", "1"])
def test_short_cell_is_correct(trace):
    _need_card()
    out = _run("portbench/run.py", "--workload", "l6-indexed-decode",
               "--seed", "2718281828", "--seconds", "2", "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_control_fails_on_the_card():
    _need_card()
    out = _run("portbench/control.py", "--workload", "l6-indexed-decode",
               "--side", "control", "--seeds", "11", "--seconds", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    runs = json.loads(out.stdout.strip().splitlines()[-1])["runs"]
    assert all(r["correct"] is False for r in runs)
