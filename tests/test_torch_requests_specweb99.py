"""nginx's gzip filter on SPECweb99's file set (the benchmark's
`l1-requests`): the request kind's cycle, compress_cuda's host route
(level 0, inputs under 1,024 B) as a traced call of its own, the answers
at the file set's edge sizes against stdlib zlib, and the cell driven
through the harness on the CPU at small sizes. This file imports nothing
of JAX."""
import json
import time
import types
import zlib
from pathlib import Path

import pytest
import torch

from portbench import control, harness, loadgen, reference
from portbench.generators import mixed_kinds, text_kinds
from zlibng_tpu_torch import compress_cuda
from zlibng_tpu_torch.ops import deflate

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads(
    (ROOT / "portbench/configs/gzip-l1-nginx-specweb99.json").read_text())
LIMIT = CONFIG["checks"]["size_excess_pct"]
KIND = loadgen.module("requests", "specweb99")
CELL = "l1-requests"
# inside text_kinds' copy of test.txt (432,640-612,641)
PERIODIC = 440_000


@pytest.fixture(scope="module")
def text():
    return text_kinds.make(0)


# ---------------------------------------------------------------------------
# the traffic and the data
# ---------------------------------------------------------------------------
def test_one_cycle_is_specwebs_file_set(text):
    sizes = KIND.sizes({}, len(text))
    assert len(sizes) == 900 and sum(sizes) == 13_524_340
    by_class = [sum(1 for s in sizes if 10 ** c * 1024 // 10 <= s
                    < 10 ** (c + 1) * 1024 // 10) for c in range(4)]
    assert by_class == [315, 450, 126, 9]
    assert sorted(set(sizes)) == sorted(
        k * 1024 * 10 ** c // 10 for c in range(4) for k in range(1, 10))
    assert min(sizes) == 102 and max(sizes) == 921_600 <= len(text)


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_text_is_the_head_of_mixed_kinds(seed):
    got = text_kinds.make(seed)
    assert len(got) == text_kinds.TEXT_BYTES == 4_855_137
    assert got == mixed_kinds.make(seed)[:len(got)]


# ---------------------------------------------------------------------------
# the host route: a root, a span and a route counter of its own
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("level,n", [(1, 921), (1, 102), (0, 5000)])
def test_host_call_after_card_call_reads_its_own_call(text, level, n):
    """A host-routed call publishes its own record: no stage clock and no
    wait of the card call before it survives (the view used to keep the
    last card call's readings)."""
    card = compress_cuda(text[:3000], 1, wbits=31, device="cpu")
    assert zlib.decompress(card, 31) == text[:3000]
    assert deflate.stage_seconds["stage1"] > 0
    assert deflate.stage_seconds["syncs.n"] > 0
    assert deflate.stage_seconds["compress.calls.card.n"] == 1
    assert "compress.calls.host.n" not in deflate.stage_seconds
    out = compress_cuda(text[:n], level, wbits=31, device="cpu")
    assert zlib.decompress(out, 31) == text[:n]
    st = deflate.stage_seconds
    assert st["host_encode"] > 0
    assert st["stage1"] == st["stage2"] == st["stitch"] == 0
    assert st["syncs.n"] == 0
    assert st["compress.calls.host.n"] == 1
    assert "compress.calls.card.n" not in st
    assert "frame" not in st and "stage2.render" not in st


def test_each_call_counts_exactly_one_route(text):
    seen = []
    publish = deflate._publish

    def keep(call):
        seen.append(dict(call.counts))
        publish(call)

    deflate._publish = keep
    try:
        for n in (102, 1023, 1024, 9216, 0, 70_000):
            compress_cuda(text[:n], 1, wbits=31, device="cpu")
    finally:
        deflate._publish = publish
    routes = [tuple(c.get(k, 0) for k in ("compress.calls.host",
                                          "compress.calls.card"))
              for c in seen]
    assert routes == [(1, 0), (1, 0), (0, 1), (0, 1), (1, 0), (0, 1)]


def test_host_route_waits_on_no_card(monkeypatch, text):
    """device="cuda" with a small input: the host encoder runs inside the
    root and records no CUDA event and synchronizes nothing."""
    def refused(*a, **k):
        raise AssertionError("the host route touched the card")

    want = compress_cuda(text[:700], 1, wbits=31, device="cpu")
    monkeypatch.setattr(deflate, "_device",
                        lambda device, who="": torch.device(device))
    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    monkeypatch.setattr(torch.cuda, "current_stream", refused)
    assert compress_cuda(text[:700], 1, wbits=31, device="cuda") == want
    assert deflate.stage_seconds["compress.calls.host.n"] == 1
    assert deflate.stage_seconds["syncs.n"] == 0


# ---------------------------------------------------------------------------
# the answers at the file set's edges, against the plain reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [102, 921, 1024, 9216, 92_160, 102_400])
@pytest.mark.parametrize("off", [0, PERIODIC, 1_000_000])
def test_response_reads_back_within_the_size_limit(text, n, off):
    """At the pigz sources, inside test.txt ("abcabc...", where the port's
    L1 is furthest from zlib's: ~2,050% over at 102,400 B) and in the
    skewed-word text."""
    body = text[off:off + n]
    out = compress_cuda(body, 1, wbits=31, device="cpu")
    assert reference.stream_ok(body, out, 31)
    own = reference.zlib_stream(body, 1, 31, 0, 8)
    assert 100.0 * (len(out) / len(own) - 1.0) <= LIMIT
    if off == PERIODIC and n >= 9216:
        # the control, zlib's stored blocks, is caught there
        ctl = reference.control_compress(body, CONFIG["codec"])
        assert 100.0 * (len(ctl) / len(own) - 1.0) > LIMIT


# ---------------------------------------------------------------------------
# the cell through the harness on the CPU, at small sizes
# ---------------------------------------------------------------------------
SMALL_MAX = 9216          # classes 0 and 1: the host route and one lane
SMALL = {"traffic": {"profile_calls": 3}}


@pytest.fixture
def small_cell(monkeypatch):
    """The cell on 40,000 B of its data (the end of the pigz sources and
    the start of test.txt), with class 0's and 1's requests only (a CPU
    call of class 3 takes seconds)."""
    make, load = harness.make_data, loadgen.module

    def module(kind, name):
        mod = load(kind, name)
        if kind != "requests":
            return mod
        return types.SimpleNamespace(sizes=lambda params, n: [
            s for s in mod.sizes(params, n) if s <= SMALL_MAX])

    monkeypatch.setattr(harness, "make_data", lambda config, seed:
                        make(config, seed)[425_000:465_000])
    monkeypatch.setattr(loadgen, "module", module)


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_reports_the_cells_metrics(small_cell, trace):
    result = harness.run_cell(CELL, 2**31 + 777, 0.3, bool(trace),
                              time.perf_counter(), device="cpu",
                              overrides=SMALL, log=lambda s: None)
    assert result["correct"] is True and result["failed"] == 0
    checks = result["checks"]
    assert checks["size_excess_pct"]["limit"] == LIMIT
    metrics = result["metrics"]
    if not trace:
        assert set(metrics) == {"compress_MBps", "setup_s"}
        return
    assert metrics["host_encode.ms_per_MiB"]["value"] > 0
    # the seed's cycle opens with 204 B (host) and 2,048 B (card)
    share = metrics["compress.host_calls_pct"]["value"]
    assert 0 < share < 100
    for name in ("stage1.ms_per_MiB", "stage2_quick.ms_per_MiB",
                 "stitch.ms_per_MiB", "compress.syncs_per_MiB"):
        assert metrics[name]["value"] > 0, name
    # spans that host-routed calls lack: their readers read nothing here
    for name in ("frame.ms_per_MiB", "stage2.render_ms_per_MiB",
                 "stage2.pack_ms_per_MiB", "stitch.fetch_ms_per_MiB"):
        assert name not in metrics, name


def test_host_share_counts_the_routes():
    read = loadgen.module("metrics", "compress.host_calls_pct").read
    host = {"stage": {"compress.calls.host.n": 1, "syncs.n": 0},
            "err": None, "bytes_in": 500}
    card = {"stage": {"compress.calls.card.n": 1, "syncs.n": 4},
            "err": None, "bytes_in": 5000}
    stale = {"stage": {"stage1": 0.1, "syncs.n": 4}, "err": None,
             "bytes_in": 500}
    assert read({"calls": [host, card, card, host]}) == 50.0
    assert read({"calls": [card] * 3}) == 0.0
    # a program that does not count its routes reads nothing
    assert read({"calls": [card, stale]}) is None
    span = loadgen.module("metrics", "host_encode.ms_per_MiB").read
    assert span({"calls": [card, stale]}) is None


@pytest.mark.parametrize("side", ("control",) + control.FAULTS)
def test_control_and_faults_are_not_correct(small_cell, side):
    (result,) = control.run(CELL, [2**32 + 99], 0.3, side, device="cpu",
                            overrides=SMALL, log=lambda s: None)
    assert result["correct"] is False
    checks = result["checks"]
    if side == "control":
        assert checks["wrong_answers"]["value"] == 0
        assert checks["size_excess_pct"]["value"] > LIMIT
    else:
        assert checks["wrong_answers"]["value"] >= 1
