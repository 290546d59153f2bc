"""Stage 2's render kernel (`csrc/render.cu`) against its plain version
(`ops/bitpack.py:render_tokens`), bit for bit, with no tolerance.

`render_rows` routes by device: CPU tensors take the plain render, CUDA
tensors the kernel (or it raises), any other device raises. Without a card
the kernel's own source still runs: the C++ compiler builds it against the
host model in `tests/cuda_model/` (a block's threads as fibers, a warp
shuffle two barriers), and the wrapper's own marshalling (shape checks,
each input's lane and unit strides, the outputs) hands it its arguments,
so the CPU tests hold the kernel's arithmetic and the views it reads in
place to the plain version too. Every run writes into outputs with guard
elements after the last row and a nonzero sentinel everywhere, so an
element written out of bounds or left unwritten shows. Tests marked `gpu`
run it on the card, and hold whole streams of `compress_cuda` and
`compress_multichip` to the plain render's. This file imports nothing of
JAX at module level, so on a machine with a card and no JAX it runs as
`python -m pytest --noconftest -m gpu tests/test_torch_render_kernel.py`.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from zlibng_tpu_torch import _build
from zlibng_tpu_torch.ops import bitpack, deflate
from zlibng_tpu_torch.ops.bitpack import (
    code_tables, render_rows, render_tokens,
)
from zlibng_tpu_torch.parallel import sharded

from torch_corpus import pigz, text

MODEL = Path(__file__).resolve().parent / "cuda_model"
GUARD = 40                      # sentinel elements after the last row
SENTINEL = -0x5A5A5A5B          # in every output element before a run
TILE = 2048                     # positions a block takes per step (kChunk)
UNIT = deflate.UNIT
HIST = deflate.LANE_HIST
SHARD_N = HIST + 163_840        # a sharded lane: history + 160 KiB


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The kernels of csrc/render.cu built with the host model, behind the
    wrapper `_render_rows_cuda` (its checks of the card skipped): a
    function (lits, tok_len, tok_dist, sel, ll, lc, dl, dc, demote) ->
    (lo, hi, nbits) on CPU tensors, which checks the guard elements."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) for the kernel's host model")
    lib = tmp_path_factory.mktemp("render_model") / "render_model.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    f"-I{MODEL}", f"-I{_build.CSRC}",
                    str(MODEL / "render_model.cpp"), "-o", str(lib)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).zng_render_model
    fn.argtypes = _build._SIGNATURES["render"][1][:-1]
    fn.restype = None

    def launch(name, dev, *args):
        assert name == "render" and dev.type == "cpu"
        lo, hi, nbits = args[17:20]
        R, N = nbits.shape
        outs = [torch.full((R * N + GUARD,), SENTINEL, dtype=t.dtype)
                for t in (lo, hi, nbits)]
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args[:17] + tuple(outs) + args[20:]]
        fn(*ptrs)
        for o, t in zip(outs, (lo, hi, nbits)):
            assert (o[R * N:] == SENTINEL).all(), "wrote past the rows"
            t.copy_(o[:R * N].view(R, N))

    def cpu_check(what, *tensors, dev=None, **_):
        return torch.device("cpu")

    def run(*args, demote=False):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_build, "launch", launch)
            mp.setattr(_build, "check_rows", cpu_check)
            mp.setattr(_build, "check_cuda", cpu_check)
            return bitpack._render_rows_cuda(*args, demote)
    return run


def _static(dev="cpu"):
    """The static code tables (288,) and (30,)."""
    C = code_tables(dev)
    return C["fl288"], C["flc"], C["fdl"], C["fdc"]


def _dynamic(R: int, seed: int, zeros: float = 0.0):
    """R rows of random tables: lengths 1-15 (a share `zeros` of the
    literal lengths 0, a byte with no code), codes below 2^length."""
    rng = np.random.default_rng(seed)
    ll = rng.integers(1, 16, (R, 288))
    ll[rng.random((R, 288)) < zeros] = 0
    dl = rng.integers(1, 16, (R, 30))
    lc = rng.integers(0, 1 << 15, (R, 288)) % (1 << ll)
    dc = rng.integers(0, 1 << 15, (R, 30)) % (1 << dl)
    return tuple(torch.from_numpy(t.astype(np.int32))
                 for t in (ll, lc, dl, dc))


def _tokens(R: int, N: int, seed: int, p_match=0.3, lengths=None,
            dists=None, past_end=False, overlap=0.0, empty=(),
            dtype=torch.int32):
    """(lits, tok_len, tok_dist, sel) rows of a parse: at each step a
    match (probability p_match; length from `lengths`, else 3-258 mostly
    short; distance from `dists`, else 1-32,768) whose inner positions go
    unselected, or a literal. With past_end a row's last match may run
    past N (the clamp at N); `overlap` is the share of matches whose
    successor starts inside them (overlapping spans); rows in `empty`
    select nothing."""
    rng = np.random.default_rng(seed)
    lits = rng.choice(np.arange(256), (R, N), p=_byte_mix()).astype(np.uint8)
    tl = np.zeros((R, N), np.int64)
    td = np.zeros((R, N), np.int64)
    sel = np.zeros((R, N), bool)
    for r in range(R):
        if r in empty:
            continue
        pos = 0
        while pos < N:
            sel[r, pos] = True
            if rng.random() >= p_match:
                pos += 1
                continue
            L = int(rng.choice(lengths) if lengths is not None else
                    min(258, 2 + rng.geometric(0.15)))
            if not past_end:
                L = min(L, N - pos)
            if L < 3:
                pos += 1
                continue
            tl[r, pos] = L
            td[r, pos] = int(rng.choice(dists) if dists is not None
                             else rng.integers(1, 32769))
            pos += int(rng.integers(1, L)) if rng.random() < overlap else L
    return (torch.from_numpy(lits), torch.from_numpy(tl).to(dtype),
            torch.from_numpy(td).to(dtype), torch.from_numpy(sel))


def _byte_mix():
    """Text-like bytes: most mass on 32 symbols, the rest spread."""
    p = np.full(256, 0.2 / 224)
    p[32:64] = 0.8 / 32
    return p


def _assert_same(got, want, what: str) -> None:
    for name, g, w in zip(("lo", "hi", "nbits"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {name}"
        bad = (g.cpu() != w.cpu())
        assert not bad.any(), (f"{what}: {name} differs at "
                               f"{bad.nonzero()[:6].tolist()}")


def _check_model(model, toks, tables, demote: bool, what: str):
    """The model behind the wrapper against the plain render; returns the
    plain render's outputs."""
    want = render_tokens(*(t.flatten(0, -2) for t in toks), *tables,
                         demote=demote)
    _assert_same(model(*toks, *tables, demote=demote), want, what)
    return want


# ---- the wrapper's routes (no card) -------------------------------------
def test_render_rows_routes_cpu_tensors_to_plain():
    toks = _tokens(3, 700, 1)
    n0 = bitpack.launches
    for demote in (False, True):
        _assert_same(render_rows(*toks, *_static(), demote=demote),
                     render_tokens(*toks, *_static(), demote=demote),
                     f"cpu route, demote {demote}")
    units = tuple(t.reshape(3, 7, 100) for t in toks)
    _assert_same(render_rows(*units, *_static(), demote=True),
                 render_tokens(*(t.reshape(21, 100) for t in toks),
                               *_static(), demote=True),
                 "cpu route, (B, Q, N) units")
    assert bitpack.launches == n0 == _build.launches["render"]


def test_render_rows_raises_off_cpu_and_cuda_and_on_bad_cuda_input():
    toks = _tokens(2, 64, 2)
    tabs = _static()
    with pytest.raises(ValueError, match="unsupported device"):
        render_rows(*(t.to("meta") for t in toks), *tabs)
    # the kernel's own checks that run without a card
    cuda = bitpack._render_rows_cuda
    lits, tl, td, sel = toks
    with pytest.raises(ValueError, match="alike"):
        cuda(lits[:, :63], tl, td, sel, *tabs, False)
    with pytest.raises(ValueError, match="alike"):
        cuda(lits[0], tl[0], td[0], sel[0], *tabs, False)
    with pytest.raises(ValueError, match="code tables"):
        cuda(*toks, tabs[0][:286], *tabs[1:], False)
    with pytest.raises(ValueError, match="code tables"):
        cuda(*toks, *_dynamic(3, 0), False)           # 3 rows' tables, R 2
    with pytest.raises(ValueError, match="code tables"):
        cuda(*toks, tabs[0], tabs[1], *_dynamic(2, 0)[2:], False)
    with pytest.raises(ValueError, match="one dtype"):
        cuda(lits, tl.long(), td, sel, *tabs, False)
    with pytest.raises(ValueError, match="uint8"):
        cuda(lits.int(), tl, td, sel, *tabs, False)
    with pytest.raises(ValueError, match="int32 or int64"):
        _build.check_rows("render kernel", tl.short(),
                          dtypes=(torch.int32, torch.int64))
    with pytest.raises(ValueError, match="bool"):
        _build.check_rows("render kernel", sel.to(torch.uint8),
                          dtypes=(torch.bool,))
    with pytest.raises(ValueError, match="unit stride"):
        cuda(*(t[:, ::2] for t in toks), *tabs, False)
    with pytest.raises(ValueError, match="CUDA"):
        cuda(*toks, *tabs, False)


def test_kernel_list_names_render_and_its_build_raises_without_nvcc(
        monkeypatch, tmp_path):
    assert "render" in _build.KERNELS
    assert (_build.CSRC / "render.cu").exists()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_funcs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernel("render")
    assert not (tmp_path / "build").exists() or \
        not list((tmp_path / "build").glob("*.so"))


# ---- the kernel's source on the host model (no card) --------------------
ROUTES = {
    # L1: the static tables, no demotion, a lane group's units
    "L1": dict(R=4, N=UNIT, tables="static", demote=False),
    # Z_FIXED: the static tables with the demotion
    "Z_FIXED": dict(R=3, N=UNIT, tables="static", demote=True),
    # L2-L9: per-unit dynamic tables with the demotion, some bytes
    # without a code inside matches' spans
    "L6": dict(R=3, N=UNIT, tables="dynamic", demote=True),
    # the sharded steps: per-lane tables on a lane's history + payload
    "sharded": dict(R=2, N=SHARD_N, tables="dynamic", demote=False),
}


@pytest.mark.parametrize("route", ROUTES)
def test_kernel_model_matches_plain_per_route(model, route):
    c = ROUTES[route]
    toks = _tokens(c["R"], c["N"], seed=len(route))
    tables = _static() if c["tables"] == "static" else \
        _dynamic(c["R"], 3, zeros=0.05)
    want = _check_model(model, toks, tables, c["demote"], route)
    if c["demote"]:       # some match was demoted here
        assert (render_tokens(*toks, *tables)[2] != want[2]).any()


@pytest.mark.parametrize("case", [
    "length 3", "length 258", "distance 1", "distance 32768",
    "past the row's end", "overlapping spans", "nothing selected",
    "every position a match", "lengths 1-2 and distance 0"])
@pytest.mark.parametrize("demote", [False, True])
def test_kernel_model_matches_plain_on_token_shapes(model, case, demote):
    kw = {"length 3": dict(lengths=[3]), "length 258": dict(lengths=[258]),
          "distance 1": dict(dists=[1]), "distance 32768": dict(dists=[32768]),
          "past the row's end": dict(lengths=[258, 200], past_end=True,
                                     p_match=0.5),
          "overlapping spans": dict(overlap=0.7, p_match=0.6),
          "nothing selected": dict(empty=(0, 1, 2)),
          "every position a match": dict(p_match=1.0, overlap=1.0),
          "lengths 1-2 and distance 0": {}}[case]
    N = 3 * TILE + 300 if case != "past the row's end" else 5000
    toks = _tokens(3, N, seed=N + len(case), **kw)
    if case == "past the row's end":   # each row ends inside a match
        for r in range(3):
            toks[1][r, N - 100] = 258
            toks[2][r, N - 100] = 4
            toks[3][r, N - 100] = True
    if case == "lengths 1-2 and distance 0":   # clamped to 3 and 1
        m = toks[1] > 0
        toks[1][m] = torch.where(toks[2][m] % 2 == 0, 1, 2).to(toks[1].dtype)
        toks[2][m & (toks[2] % 3 == 0)] = 0
    for tables in (_static(), _dynamic(3, 5, zeros=0.05)):
        _check_model(model, toks, tables, demote, f"{case}, demote {demote}")


@pytest.mark.parametrize("R,N", [(1, 1), (1, 3001), (2, TILE - 1),
                                 (2, TILE + 1), (1, TILE + 258),
                                 (3, 2 * TILE - 5), (2, 0)])
def test_kernel_model_matches_plain_at_ragged_shapes(model, R, N):
    """R = 1, N off the tile and off the window, an empty row length."""
    toks = _tokens(R, N, seed=R * 7 + N)
    for demote in (False, True):
        for tables in (_static(), _dynamic(R, N, zeros=0.05)):
            _check_model(model, toks, tables, demote, f"{R}x{N} {demote}")


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("demote", [False, True])
def test_kernel_model_reads_strided_views_in_place(model, dtype, demote):
    """The call sites' views, read where they lie: a lane's payload cut
    into (B, Q, UNIT) units past a 32 KiB history (tokens, bytes of a flat
    buffer), and sliced (R, N) rows; tok_len and tok_dist int32 or int64."""
    B, Q = 2, 3
    toks = _tokens(B, HIST + Q * UNIT, seed=11, dtype=dtype)
    units = tuple(t[:, HIST:].view(B, Q, UNIT) for t in toks)
    flat = torch.cat([toks[0][0, :HIST], toks[0][:, HIST:].reshape(-1)])
    units = (flat[HIST:].view(B, Q, UNIT),) + units[1:]
    assert not units[1].is_contiguous()
    tables = _dynamic(B * Q, 9, zeros=0.05) if demote else _static()
    _check_model(model, units, tables, demote, "(B, Q, UNIT) units")
    rows = tuple(t[:, 100:-7] for t in toks)
    _check_model(model, rows, _static(), demote, "sliced rows")


@pytest.fixture(scope="module")
def cpu_render_calls():
    """The arguments of every render_rows call of CPU compress calls, as
    they came (views of the group's buffers): L6, L1 and Z_FIXED of two
    real files (three lanes in a group of four, the last a pad lane), and
    compress_multichip on two CPU shards at pigz's block size."""
    seen = []

    def record(*args, demote=False):
        seen.append((args, demote))
        return render_rows(*args, demote=demote)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(deflate, "render_rows", record)
        mp.setattr(sharded, "render_rows", record)
        data = text()[:150_000] + pigz()[:1 << 17]
        for level, strategy in ((6, 0), (1, 0), (6, 4)):
            deflate.compress_cuda(data, level, strategy=strategy,
                                  device="cpu")
        sharded.compress_multichip(text(), ["cpu"] * 2, lane_block=1 << 17)
    return seen


def test_kernel_model_matches_plain_on_real_render_calls(model,
                                                         cpu_render_calls):
    shapes = {(tuple(a[3].shape), a[4].dim(), d)
              for a, d in cpu_render_calls}
    assert shapes == {((4, 8, UNIT), 2, True), ((4, 8, UNIT), 1, False),
                      ((4, 8, UNIT), 1, True), ((1, HIST + (1 << 17)), 2,
                                                False)}
    for k, (args, demote) in enumerate(cpu_render_calls):
        _check_model(model, args[:4], args[4:], demote,
                     f"call {k} {tuple(args[3].shape)}")


# ---- the kernel on the card ---------------------------------------------
def _on_card(card, toks, tables, demote):
    """render_rows on `card`, asserting one launch."""
    n0 = bitpack.launches
    out = render_rows(*(t.to(card) for t in toks),
                      *(t.to(card) for t in tables), demote=demote)
    torch.cuda.synchronize()
    assert bitpack.launches == n0 + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_render_kernel_matches_plain_on_card(card, route):
    """The four call sites' shapes: a lane group's 128 units (L1, Z_FIXED,
    L6) and a shard's 17 lanes (8.5 MiB over four shards)."""
    c = ROUTES[route]
    R = 17 if route == "sharded" else 128
    toks = _tokens(R, c["N"], seed=len(route))
    tables = _static() if c["tables"] == "static" else \
        _dynamic(R, 3, zeros=0.05)
    want = render_tokens(*(t.to(card) for t in toks),
                         *(t.to(card) for t in tables), demote=c["demote"])
    _assert_same(_on_card(card, toks, tables, c["demote"]), want, route)


@pytest.mark.gpu
@pytest.mark.parametrize("demote", [False, True])
def test_render_kernel_reads_views_on_card(card, demote):
    B, Q = 3, 8
    toks = _tokens(B, HIST + Q * UNIT, seed=5, dtype=torch.int64,
                   past_end=True, overlap=0.2)
    dev = tuple(t.to(card) for t in toks)
    units = tuple(t[:, HIST:].view(B, Q, UNIT) for t in dev)
    tables = tuple(t.to(card) for t in _dynamic(B * Q, 4, zeros=0.05))
    n0 = bitpack.launches
    got = render_rows(*units, *tables, demote=demote)
    want = render_tokens(*(t[:, HIST:].reshape(B * Q, UNIT) for t in dev),
                         *tables, demote=demote)
    _assert_same(got, want, "(B, Q, UNIT) units")
    got = render_rows(*(t[:, 1:] for t in dev), *_static(card),
                      demote=demote)
    want = render_tokens(*(t[:, 1:] for t in dev), *_static(card),
                         demote=demote)
    _assert_same(got, want, "sliced rows")
    assert bitpack.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("level,strategy", [(6, 0), (9, 0), (1, 0), (6, 4)])
def test_compress_cuda_streams_equal_plain_render_and_count_launches(
        card, monkeypatch, level, strategy):
    """compress_cuda of the smoke corpus with the kernel, then with the
    plain render on the card: the same stream, and the CPU route's on a
    1 MiB prefix. Launches: 1 per L2-L9 lane group and redispatch, 1 per
    quick-path group with a coded unit (one `_stage2_fixed` call)."""
    data, _ = chip_smoke.corpus()
    fixed = deflate._stage2_fixed
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return fixed(*a, **k)
    monkeypatch.setattr(deflate, "_stage2_fixed", counted)
    n0 = _build.launches["render"]
    out = deflate.compress_cuda(data, level, strategy=strategy, device=card)
    launches = _build.launches["render"] - n0
    st = dict(deflate.stage_seconds)
    assert st.get("render.launches.n", 0) == launches
    if level > 1 and strategy != 4:
        groups = st["stage2.groups.n"] + st["stage2.redispatch.n"]
        assert launches == groups and calls == []
    else:
        assert launches == len(calls) > 0
    prefix = data[: 1 << 20]
    assert deflate.compress_cuda(prefix, level, strategy=strategy,
                                 device=card) == deflate.compress_cuda(
        prefix, level, strategy=strategy, device="cpu")
    monkeypatch.setattr(deflate, "render_rows", _plain_render)
    n0 = _build.launches["render"]
    assert deflate.compress_cuda(data, level, strategy=strategy,
                                 device=card) == out
    assert _build.launches["render"] == n0


def _plain_render(*args, demote=False):
    """render_tokens on render_rows' arguments (the plain render on the
    card: (B, Q, N) units flattened to rows)."""
    return render_tokens(*(t.flatten(0, -2) for t in args[:4]), *args[4:],
                         demote=demote)


@pytest.mark.gpu
def test_compress_multichip_streams_equal_plain_render(card, monkeypatch):
    """compress_multichip over every card present, at pigz's block size:
    one launch per shard, and the plain render's stream."""
    data, _ = chip_smoke.corpus()
    data = data[: 4 << 20]
    devs = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    n0 = _build.launches["render"]
    out = sharded.compress_multichip(data, devs, lane_block=1 << 17)
    assert _build.launches["render"] - n0 == len(devs)
    monkeypatch.setattr(sharded, "render_rows", _plain_render)
    assert sharded.compress_multichip(data, devs, lane_block=1 << 17) == out
