"""The correctness check fails where it should: with the control (the
plain reference with less than the configuration states) in the
program's place, and with each fault a cell can have planted under the
timed path."""
import sys
import zlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import control, reference  # noqa: E402
from small import SMALL, cut_data  # noqa: E402

CASES = [(w, s) for w in sorted(SMALL) for s in ("control",)
         + control.FAULTS]


@pytest.mark.parametrize("workload,side", CASES,
                         ids=[f"{w}-{s}" for w, s in CASES])
def test_check_fails(monkeypatch, workload, side):
    cut_data(monkeypatch)
    (result,) = control.run(workload, [2**32 + 99], 0.05, side,
                            device="cpu", overrides=SMALL[workload],
                            log=lambda s: None)
    assert result["correct"] is False
    checks = result["checks"]
    if side == "control" and "size_excess_pct" in checks:
        # the control's streams decode: only their size gives them away
        assert checks["wrong_answers"]["value"] == 0
        assert checks["size_excess_pct"]["value"] \
            > checks["size_excess_pct"]["limit"]
    else:
        assert checks["wrong_answers"]["value"] >= 1


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_program_side_is_correct(monkeypatch, workload):
    cut_data(monkeypatch)
    (result,) = control.run(workload, [7], 0.05, "program", device="cpu",
                            overrides=SMALL[workload], log=lambda s: None)
    assert result["correct"] is True


def test_reference_accepts_zlib_and_rejects_a_flipped_byte():
    data = bytes(range(256)) * 64
    for wbits in (15, 31, -15):
        s = reference.zlib_stream(data, 6, wbits)
        assert reference.stream_ok(data, s, wbits)
        assert not reference.stream_ok(data, control._flip(s), wbits)
        assert not reference.stream_ok(data, s + b"\0", wbits)


@pytest.mark.parametrize("level,strategy", [(6, 0), (1, 0)])
def test_size_check_holds_zlibs_own_stream_and_fails_the_control(
        level, strategy):
    data = b"".join(b"%d the quick brown fox %d\n" % (i, i * i % 97)
                    for i in range(3000))
    codec = dict(level=level, strategy=strategy, wbits=31)
    req = (0, len(data))
    own = reference.zlib_stream(data, level, 31, strategy)
    ctl = reference.control_compress(data, codec)
    assert zlib.decompress(ctl, 31) == data
    limits = {"size_excess_pct": 5.0}
    good = reference.judge("compress", codec, limits,
                           [(req, data, own)], 0)
    bad = reference.judge("compress", codec, limits,
                          [(req, data, ctl)], 0)
    assert good["size_excess_pct"]["value"] == 0.0
    assert bad["size_excess_pct"]["value"] > 5.0
    assert bad["wrong_answers"]["value"] == 0
