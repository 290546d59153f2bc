"""The port's span-and-counter facility (`zlibng_tpu_torch/trace.py`): call
roots, nesting, ids, counters, the one helper through which the host
waits for a device, the trace lines, the profiler's ranges, and the views
a compress and a decode fill (`ops/deflate.py:stage_seconds`,
`ops/inflate.py:decode_stats`). The CPU tests run everywhere; the tests
marked `gpu` hold the `syncs` counter to torch's sync-debug warnings and
the profiler's ranges to the spans on a card, and skip without one. This
file imports nothing of JAX:
`python -m pytest --noconftest -m gpu tests/test_torch_trace.py` on the
card."""
import collections
import os
import random
import subprocess
import sys
import warnings
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zlibng_tpu_torch import compress_cuda, decompress_cuda, trace
from zlibng_tpu_torch.ops import deflate, inflate
from zlibng_tpu_torch.parallel import index

from torch_corpus import pigz, text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _recorded(module, fn):
    """fn()'s result and the record of the last call it made, caught at
    `module._publish` (ops/deflate.py or ops/inflate.py)."""
    seen = []
    publish = module._publish

    def keep(call):
        seen.append(call)
        publish(call)

    module._publish = keep
    try:
        out = fn()
    finally:
        module._publish = publish
    return out, seen[-1]


def _parents_hold_children(call):
    """Every span lies inside its parent on the host's clock."""
    for sp in call.spans[1:]:
        p = sp.parent
        assert p is not None and p.t0 <= sp.t0 and sp.t1 <= p.t1, sp.name
        assert sp.host_s <= p.host_s


# ---------------------------------------------------------------------------
# the facility
# ---------------------------------------------------------------------------
def test_spans_nest_under_a_call_with_ids():
    seen = []
    with trace.call("outer", seen.append) as c:
        with trace.span("a", group=3):
            with trace.span("a.b", wave=1, cb=2048):
                pass
        with trace.span("c"):
            pass
    with trace.call("next", seen.append) as c2:
        pass
    assert seen == [c, c2] and c2.id > c.id
    names = [(sp.name, sp.parent.name if sp.parent else None, sp.ids)
             for sp in c.spans]
    assert names == [("outer", None, {}), ("a", "outer", {"group": 3}),
                     ("a.b", "a", {"wave": 1, "cb": 2048}),
                     ("c", "outer", {})]
    assert [sp.index for sp in c.spans] == [0, 1, 2, 3]
    _parents_hold_children(c)
    # on the CPU a span has no device time: its seconds are the host's
    assert all(sp.device_s is None for sp in c.spans)
    totals = c.totals()
    assert set(totals) == {"outer", "a", "a.b", "c"}
    assert totals["a.b"] == c.spans[2].host_s


def test_counters_add_to_the_innermost_call():
    seen = []
    with trace.call("x", seen.append):
        trace.count("waves")
        with trace.span("inner"):
            trace.count("waves", 4)
            trace.count("lanes", 0)
    trace.count("waves", 100)                   # outside: nothing
    assert seen[0].counts == {"syncs": 0, "sync_bytes": 0, "waves": 5,
                              "lanes": 0}


@pytest.mark.parametrize("helper", ["fetch", "item", "nonzero", "upload"])
def test_a_wait_is_counted_and_timed_as_a_fetch(helper):
    t = torch.arange(6, dtype=torch.int32)
    do = {"fetch": lambda: trace.fetch(t),
          "item": lambda: trace.item(t.max()),
          "nonzero": lambda: trace.nonzero(t > 2),
          "upload": lambda: trace.upload(np.arange(6, dtype=np.int32),
                                         torch.device("cpu"))}[helper]
    want = {"fetch": 24, "item": 4, "nonzero": 8, "upload": 24}[helper]
    seen = []
    with trace.call("x", seen.append):
        with trace.span("phase"):
            got = do()
    c = seen[0]
    assert c.counts["syncs"] == 1 and c.counts["sync_bytes"] == want
    wait = c.spans[-1]
    assert wait.name == "phase.fetch" and wait.parent.name == "phase"
    assert wait.ids == {"bytes": want} and wait.t1 >= wait.t0
    # the same values as the code it stands for
    outside = do()
    if helper == "nonzero":
        assert all(torch.equal(a, b) for a, b in zip(got, outside))
    else:
        assert np.array_equal(np.asarray(got), np.asarray(outside))


def test_outside_a_call_nothing_is_recorded():
    assert trace.span("stage1", torch.device("cpu"), group=0) \
        is trace._NOTHING
    with trace.span("x"):
        trace.count("waves")
        assert trace.item(torch.tensor(7)) == 7
    assert trace.synchronize(torch.device("cpu")) is None
    seen = []
    with trace.call("only", seen.append):
        pass
    assert [sp.name for sp in seen[0].spans] == ["only"]
    assert seen[0].counts == {"syncs": 0, "sync_bytes": 0}


def test_a_call_inside_a_call_is_part_of_it():
    seen = []
    with trace.call("outer", lambda c: seen.append(("outer", c))) as a:
        with trace.call("inner", lambda c: seen.append(("inner", c))) as b:
            with trace.span("s"):
                pass
    assert a is b and [sp.name for sp in a.spans] == ["outer", "s"]
    assert seen == [("outer", a), ("inner", a)]


def test_an_error_closes_the_call():
    seen = []
    with pytest.raises(ValueError, match="boom"):
        with trace.call("x", seen.append):
            with trace.span("deep"):
                raise ValueError("boom")
    assert [sp.name for sp in seen[0].spans] == ["x", "deep"]
    assert seen[0].spans[1].t1 >= seen[0].spans[1].t0
    assert trace.span("after") is trace._NOTHING


def test_root_waits_for_each_card_once(monkeypatch):
    """A root with device spans on a card waits for that card once, through
    the helper (counted), before it reads the events."""
    seen = {"sync": []}

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self, stream=None):
            pass

        def elapsed_time(self, other):
            return 4.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: device)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: seen["sync"].append(device))
    card = torch.device("cuda", 2)
    calls = []
    with trace.call("compress", calls.append):
        for g in range(3):
            with trace.span("stage2", card, group=g):
                with trace.span("stage2.pack", card):
                    pass
    c = calls[0]
    assert seen["sync"] == [card]
    assert c.counts["syncs"] == 1 and c.spans[-1].name == "compress.fetch"
    assert c.totals()["stage2"] == pytest.approx(0.012)
    assert c.totals()["stage2.pack"] == pytest.approx(0.012)


# ---------------------------------------------------------------------------
# trace lines
# ---------------------------------------------------------------------------
def _small_decode():
    data = text()[:8000]
    assert decompress_cuda(zlib.compress(data, 6), engine="device",
                           device="cpu") == data


def test_tracing_off_writes_no_line_yet_fills_the_views():
    lines = []
    trace.enable(False, sink=lines.append)
    try:
        _, c = _recorded(inflate, _small_decode)
    finally:
        trace.enable(False, sink=None)
    assert lines == []
    for key in ("phase_a.luts_s", "phase_a.steps_s", "phase_a.k2_s",
                "phase_a.compact_s", "phase_a.fetch_s", "phase_b.fetch_s",
                "syncs", "k2_lanes", "k2_positions", "phase_a_lanes",
                "phase_a_retries"):
        assert key in inflate.decode_stats, key
    assert inflate.decode_stats["syncs"] == c.counts["syncs"] > 0
    assert inflate.decode_stats["total_s"] == c.spans[0].host_s


def test_trace_lines_carry_the_ids_through_the_sink():
    lines = []
    trace.enable(True, sink=lines.append)
    try:
        _, c = _recorded(inflate, _small_decode)
    finally:
        trace.enable(False, sink=None)
    spans = [ln for ln in lines if f" call={c.id}" in ln]
    assert len(spans) == len(c.spans)
    assert spans[0] == f"[zlibng_tpu_torch] decode#0 call={c.id} host=" \
        f"{1e3 * c.spans[0].host_s:.3f} ms"
    wave = next(ln for ln in spans if ln.startswith(
        "[zlibng_tpu_torch] phase_a#"))
    assert " wave=0 cb=2048 parent=decode#0 host=" in wave
    assert wave.endswith(" ms")
    k2 = next(ln for ln in spans if "] phase_a.k2#" in ln)
    assert " parent=phase_a#" in k2
    assert any("] phase_a.fetch#" in ln and " bytes=" in ln for ln in spans)
    assert "[zlibng_tpu_torch] inflate route=device comp_bytes=" in \
        "\n".join(lines)


def test_trace_environment_switch_writes_to_stderr():
    code = ("import zlib\n"
            "from zlibng_tpu_torch import decompress_cuda\n"
            "d = bytes(range(256)) * 40\n"
            "assert decompress_cuda(zlib.compress(d), engine='device',"
            " device='cpu') == d\n")
    env = dict(os.environ, ZLIBNG_TPU_TRACE="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stderr.splitlines()
             if ln.startswith("[zlibng_tpu_torch] ")]
    assert any(ln.startswith("[zlibng_tpu_torch] decode#0 call=")
               for ln in lines)
    assert any(" wave=0 " in ln and "] phase_a#" in ln for ln in lines)


# ---------------------------------------------------------------------------
# the views of a compress and a decode on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def l6_call():
    data = text()[:3000]
    out, c = _recorded(deflate, lambda: compress_cuda(data, 6,
                                                      device="cpu"))
    assert zlib.decompress(out) == data
    return c, dict(deflate.stage_seconds)


def test_l6_compress_fills_every_key(l6_call):
    c, stages = l6_call
    for key in ("stage1", "stage2", "stitch", "frame", "stage2.partition",
                "stage2.huffman", "stage2.render", "stage2.pack",
                "stitch.fetch", "syncs.n", "sync_bytes.n", "stage2.groups.n",
                "stage2.redispatch.n"):
        assert key in stages, key
    assert stages["stage2.groups.n"] == 1
    assert stages["stage2.redispatch.n"] == 0
    assert stages["syncs.n"] == c.counts["syncs"] > 0
    assert [sp.name for sp in c.spans].count("frame") == 2
    stage2 = next(sp for sp in c.spans if sp.name == "stage2")
    assert stage2.ids == {"group": 0}


def test_l6_children_never_exceed_their_parent(l6_call):
    c, stages = l6_call
    _parents_hold_children(c)
    parts = sum(stages[k] for k in ("stage2.partition", "stage2.huffman",
                                    "stage2.render", "stage2.pack"))
    assert parts <= stages["stage2"]
    assert stages["stitch.fetch"] <= stages["stitch"]
    assert stages["stage2.partition.fetch"] <= stages["stage2.partition"]


def test_l1_compress_fills_the_quick_paths_keys():
    data = text()[:3000]
    out, c = _recorded(deflate, lambda: compress_cuda(data, 1, wbits=31,
                                                      device="cpu"))
    assert zlib.decompress(out, 31) == data
    stages = deflate.stage_seconds
    for key in ("stage1", "stage2", "stitch", "frame", "stage2.render",
                "stage2.pack", "stitch.fetch", "syncs.n"):
        assert key in stages, key
    for key in ("stage2.partition", "stage2.huffman", "stage2.groups.n"):
        assert key not in stages, key
    _parents_hold_children(c)
    assert stages["stage2.render"] + stages["stage2.pack"] \
        <= stages["stage2"]


def test_warm_compress_waits_only_for_what_each_group_needs(monkeypatch):
    """A warm L6 call and a warm L1 call of two lane groups each: `syncs`
    counts, per group, stage 1's two uploads, the partition's round trip
    (L6), stage 2's fetch of its descriptors or bits and the stitch's fetch,
    besides the data-dependent waits of the CPU's plain routes (stage 1's
    wide extension, the plain Huffman build). No constant code table is
    uploaded or fetched once the device's first call has cached them."""
    monkeypatch.setattr(deflate, "GROUP_BYTES", 1 << 18)
    data = (text() + pigz())[:300000]          # three 128 KiB lanes
    per_group = {
        6: {"_dispatch_stage1": 2, "_partition": 2,
            "_dispatch_stage2_auto": 1, "_stitch_auto": 1},
        1: {"_dispatch_stage1": 2, "_dispatch_stage2_quick": 1,
            "_stitch_quick": 1}}
    plain_routes = {"_wide_extension", "pick", "_rle_scan", "huff_lengths"}
    wait = trace._wait
    for level, need in per_group.items():
        compress_cuda(data, level, device="cpu")
        seen = collections.Counter()

        def spy(fn, nbytes):
            seen[sys._getframe(2).f_code.co_name] += 1   # fetch's caller
            return wait(fn, nbytes)

        monkeypatch.setattr(trace, "_wait", spy)
        out = compress_cuda(data, level, device="cpu")
        monkeypatch.setattr(trace, "_wait", wait)
        assert zlib.decompress(out) == data
        assert deflate.stage_seconds["syncs.n"] == sum(seen.values())
        assert {k: v for k, v in seen.items() if k not in plain_routes} \
            == {k: 2 * v for k, v in need.items()}, (level, seen)


def test_indexed_decode_counts_what_k2_is_handed(monkeypatch):
    data = text()[:40000]
    blob, idx = index.compress_indexed(data, 6, segment=16384)
    handed = []
    walk = inflate.parse_select

    def counted(step, bounds):
        handed.append(tuple(step.shape))
        return walk(step, bounds)

    monkeypatch.setattr(inflate, "parse_select", counted)
    out, c = _recorded(inflate, lambda: index.decompress_indexed_cuda(
        blob, idx, device="cpu"))
    assert out == data
    stats = inflate.decode_stats
    assert handed and stats["k2_lanes"] == sum(B for B, _ in handed)
    assert stats["k2_positions"] == sum(B * N for B, N in handed)
    assert stats["phase_a"] == len(handed)
    assert stats["phase_a_lanes"] == 3 and stats["phase_a_retries"] == 0
    for key in ("phase_a.luts_s", "phase_a.steps_s", "phase_a.k2_s",
                "phase_a.compact_s", "phase_a.fetch_s", "phase_a_s",
                "phase_b_s", "total_s"):
        assert stats[key] > 0, key
    _parents_hold_children(c)
    first = next(sp for sp in c.spans if sp.name == "phase_a")
    assert first.ids["wave"] == 0 and set(first.ids) == {"wave", "cb"}
    kids = [sp.name for sp in c.spans if sp.parent is first]
    # the six uploads, the four parts, the two or three fetches
    assert kids[:6] == ["phase_a.fetch"] * 6
    assert kids[6:10] == ["phase_a.luts", "phase_a.steps", "phase_a.k2",
                          "phase_a.compact"]
    assert set(kids[10:]) == {"phase_a.fetch"}


def test_lanes_sent_again_are_counted():
    """Three Huffman-only segments whose blocks hold more tokens than the
    smallest lane bucket's token array: each lane is sent again in the next
    bucket, and the bytes still come out right."""
    rng = random.Random(5)
    segs = [bytes(rng.choice(b"abcdefgh") if rng.random() < 0.03 else 97
                  for _ in range(6000)) for _ in range(3)]
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_HUFFMAN_ONLY)
    blob, starts = b"", []
    for i, s in enumerate(segs):
        starts.append(len(blob))
        blob += co.compress(s) + co.flush(
            zlib.Z_FULL_FLUSH if i < len(segs) - 1 else zlib.Z_FINISH)
    out, _ = _recorded(inflate, lambda: inflate.decompress_segments_cuda(
        blob, starts, device="cpu"))
    assert out == segs
    stats = inflate.decode_stats
    assert stats["fallback_cause"] is None
    assert stats["phase_a"] == 2 and stats["phase_a_lanes"] == 6
    assert stats["phase_a_retries"] == 3
    assert stats["k2_lanes"] == 8          # 3 lanes padded to 4, twice


def test_profiler_ranges_nest_as_the_spans():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, c = _recorded(inflate, _small_decode)
    _ranges_nest_as_spans(prof, c)


def _ranges_nest_as_spans(prof, c):
    """One `zng.<name>` host range per span, each inside a range of its
    parent's name."""
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("zng.") and e.device_type() == \
                torch.autograd.DeviceType.CPU:
            ranges[e.name()[4:]].append((e.start_ns(),
                                         e.start_ns() + e.duration_ns()))
    want = collections.Counter(sp.name for sp in c.spans)
    assert {k: len(v) for k, v in ranges.items()} == dict(want)
    for sp in c.spans[1:]:
        assert any(p0 <= a and b <= p1 for a, b in ranges[sp.name]
                   for p0, p1 in ranges[sp.parent.name]), sp.name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
_SYNC = "synchronizing CUDA operation"


def _sync_warnings(fn) -> list:
    """The sync-debug warnings fn() raises, and its result."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [w for w in got if _SYNC in str(w.message)], out


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["l6", "l1", "indexed"])
def test_syncs_counter_equals_the_sync_debug_warnings(card, case):
    """Every wait of one call goes through the helper: the `syncs` counter
    equals torch's sync-debug warnings, except for the root's closing
    torch.cuda.synchronize when the debug mode does not report it (it
    reports stream and copy waits, not a device's)."""
    data = pigz()
    if case == "indexed":
        blob, idx = index.compress_indexed(data, 6, segment=1 << 17)
        module = inflate

        def run():
            return index.decompress_indexed_cuda(blob, idx, device=card)
    else:
        level = 6 if case == "l6" else 1
        module = deflate

        def run():
            return compress_cuda(data, level, device=card)
    run()                                      # builds, fills the caches
    closing, _ = _sync_warnings(lambda: torch.cuda.synchronize(card))
    got, (out, c) = _sync_warnings(lambda: _recorded(module, run))
    if case == "indexed":
        assert out == data
    else:
        assert zlib.decompress(out) == data
    where = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}"
                                for w in got)
    assert c.counts["syncs"] == len(got) + (1 - len(closing)), where


@pytest.mark.gpu
def test_profiler_ranges_nest_on_the_card(card):
    data = pigz()[:300000]
    compress_cuda(data, 6, device=card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, c = _recorded(deflate, lambda: compress_cuda(data, 6,
                                                          device=card))
    assert zlib.decompress(out) == data
    _ranges_nest_as_spans(prof, c)
    # device spans read device time; children stay within their parent
    stages = deflate.stage_seconds
    for name in ("stage1", "stage2", "stage2.partition", "stage2.pack"):
        assert all(sp.device_s is not None for sp in c.spans
                   if sp.name == name), name
    parts = sum(stages[k] for k in ("stage2.partition", "stage2.huffman",
                                    "stage2.render", "stage2.pack"))
    assert 0 < parts <= stages["stage2"] + 1e-5
