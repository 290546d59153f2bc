"""Stage 2's pack kernel (`csrc/bitpack.cu`) against its plain version
(`ops/bitpack_merge.py:hierarchical_pack`) and the token-by-token
`ref_pack` of tests/test_bitpack_equiv.py, byte for byte, with no
tolerance.

`pack_rows` routes by device: CPU tensors take the plain pack, CUDA
tensors the kernel (or it raises), any other device raises. Without a card
the kernel's own source still runs: the C++ compiler builds it against the
host model in `tests/cuda_model/` (a block's threads as fibers, a warp
shuffle two barriers), with both of its load paths (16-byte and scalar)
and both of its store paths (words and bytes) on every input, so the CPU
tests hold the kernel's arithmetic to the plain version too. Every run
writes into a buffer with guard bytes after the last row and a nonzero
sentinel everywhere, so a byte written past a row or left unwritten
shows. Tests marked `gpu` run it on the card, and hold whole streams of
`compress_cuda` and `compress_multichip` to the plain route's. This file
imports nothing of JAX at module level, so on a machine with a card and no
JAX it runs as
`python -m pytest --noconftest -m gpu tests/test_torch_bitpack_kernel.py`.
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
from zlibng_tpu_torch.ops import bitpack_merge, deflate, huffman
from zlibng_tpu_torch.ops.bitpack_merge import hierarchical_pack, pack_rows
from zlibng_tpu_torch.parallel import sharded

from torch_corpus import pigz, text

MODEL = Path(__file__).resolve().parent / "cuda_model"
GUARD = 64                      # sentinel bytes after the last row
SENTINEL = 0xA5
CHUNK = 2048                    # tokens a block takes per step (kChunk)
# (R, T, out_bytes) of the three call sites: an L6 or L1 lane group's
# bodies at each bucket, its headers (HDR_SLOTS tokens; HMAX as well), and
# the sharded lanes (a 128 KiB lane's 704 header slots, 163,840 tokens and
# its EOB, in pigz's layout)
BODY = [(128, deflate.UNIT, ob) for ob in deflate.OUT_BUCKETS]
HEADERS = [(128, huffman.HDR_SLOTS, deflate.HDR_OUT),
           (128, deflate.HMAX, deflate.HDR_OUT)]
SHARD = (2, deflate.HMAX + 163_840 + 1, (1 << 17) + (1 << 15) + 1024)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The kernel of csrc/bitpack.cu built with the host model: a function
    (lo, hi, nbits, out_bytes, vec, aligned) -> (bytes, total_bits) on CPU
    tensors, which checks the guard bytes after the last row."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) for the kernel's host model")
    lib = tmp_path_factory.mktemp("bitpack_model") / "bitpack_model.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    f"-I{MODEL}", f"-I{_build.CSRC}",
                    str(MODEL / "bitpack_model.cpp"), "-o", str(lib)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).zng_bitpack_model
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    fn.restype = None

    def run(lo, hi, nbits, out_bytes, vec, aligned):
        R, T = nbits.shape
        buf = torch.full((R * out_bytes + GUARD,), SENTINEL,
                         dtype=torch.uint8)
        total = torch.full((R,), -7, dtype=torch.int32)
        fn(lo.data_ptr(), hi.data_ptr(), nbits.data_ptr(), buf.data_ptr(),
           total.data_ptr(), R, T, out_bytes, int(vec), int(aligned))
        assert (buf[R * out_bytes:] == SENTINEL).all(), "wrote past the rows"
        return buf[:R * out_bytes].reshape(R, out_bytes), total
    return run


def _flags(T: int, out_bytes: int):
    """The (vec, aligned) pairs the launcher may pick for T and out_bytes
    on aligned tensors: the scalar and byte paths take any input."""
    return [(v, a) for v in (False, True) for a in (False, True)
            if (not v or T % 4 == 0) and (not a or out_bytes % 4 == 0)]


def _tokens(R: int, T: int, kind: str, seed: int = 0):
    """(lo, hi, nbits) rows of kind: `mixed` (0-15 bits with zero runs and
    5% of 30-55), `55-bit`, `63-bit`, `zero runs` (long runs of 0-bit
    tokens between 1-20-bit ones), `sparse` (40 1-bit tokens a row, so
    several chunks end in one word), `deflate` (an L6 body's mix: 60% 0,
    the rest 7-9 literals and 20-31-bit matches). The values carry bits
    above nbits, which the pack must drop."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, (R, T), dtype=np.uint64).astype(np.int64)
    hi = rng.integers(0, 1 << 32, (R, T), dtype=np.uint64).astype(np.int64)
    if kind == "mixed":
        nb = rng.integers(0, 16, (R, T))
        nb[rng.random((R, T)) < 0.4] = 0
        big = rng.random((R, T)) < 0.05
        nb[big] = rng.integers(30, 56, int(big.sum()))
    elif kind == "55-bit":
        nb = np.full((R, T), 55)
    elif kind == "63-bit":
        nb = np.full((R, T), 63)
    elif kind == "zero runs":
        nb = rng.integers(1, 21, (R, T))
        nb[:, (np.arange(T) // 1500) % 2 == 1] = 0
    elif kind == "sparse":
        nb = np.zeros((R, T), np.int64)
        for r in range(R):
            nb[r, rng.integers(0, T, min(T, 40))] = 1
    elif kind == "deflate":
        nb = np.where(rng.random((R, T)) < 0.8, rng.integers(7, 10, (R, T)),
                      rng.integers(20, 32, (R, T)))
        nb[rng.random((R, T)) < 0.6] = 0
    else:
        raise ValueError(kind)
    return (torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(nb.astype(np.int32)))


def _ref_pack(lo, hi, nbits, out_bytes):
    """Token-by-token reference (tests/test_bitpack_equiv.py:ref_pack) of
    every row: (bytes (R, out_bytes) uint8, total_bits (R,) int32)."""
    from test_bitpack_equiv import ref_pack
    rows, bits = [], []
    for l, h, n in zip(lo.numpy() & 0xFFFFFFFF, hi.numpy() & 0x7FFFFFFF,
                       nbits.numpy()):
        b, pos = ref_pack(l, h, n, out_bytes)
        rows.append(np.frombuffer(b, np.uint8))
        bits.append(pos)
    return (torch.from_numpy(np.stack(rows)),
            torch.tensor(bits, dtype=torch.int32))


def _assert_same(got, want, what: str) -> None:
    (gb, gt), (wb, wt) = got, want
    assert gb.dtype == wb.dtype == torch.uint8 and gb.shape == wb.shape, what
    assert gt.dtype == wt.dtype == torch.int32 and gt.shape == wt.shape, what
    bad = (gb.cpu() != wb).any(1) | (gt.cpu() != wt)
    assert not bad.any(), \
        f"{what}: rows {bad.nonzero().flatten()[:8].tolist()} differ"


def _check_model(model, lo, hi, nbits, out_bytes, what: str, ref=False,
                 every_path=True):
    """The model on every load and store path (without `every_path`, on
    the launcher's pick alone) against the plain pack (and the
    token-by-token reference with `ref`)."""
    want = hierarchical_pack(lo, hi, nbits, out_bytes)
    if ref:
        _assert_same(want, _ref_pack(lo, hi, nbits, out_bytes),
                     f"{what}: plain against ref_pack")
    paths = _flags(nbits.shape[1], out_bytes)
    for vec, aligned in paths if every_path else paths[-1:]:
        _assert_same(model(lo, hi, nbits, out_bytes, vec, aligned), want,
                     f"{what}, vec {vec}, aligned {aligned}")


# ---- the wrapper's routes (no card) -------------------------------------
def test_pack_rows_routes_cpu_tensors_to_plain():
    lo, hi, nb = _tokens(3, 700, "mixed")
    n0 = bitpack_merge.launches
    _assert_same(pack_rows(lo, hi, nb, 600),
                 hierarchical_pack(lo, hi, nb, 600), "cpu route")
    assert bitpack_merge.launches == n0


def test_pack_rows_raises_off_cpu_and_cuda_and_on_bad_cuda_input():
    lo, hi, nb = _tokens(2, 64, "mixed")
    with pytest.raises(ValueError, match="unsupported device"):
        pack_rows(lo.to("meta"), hi.to("meta"), nb.to("meta"), 64)
    # the kernel's own checks that run without a card
    cuda = bitpack_merge._pack_rows_cuda
    with pytest.raises(ValueError, match="alike"):
        cuda(lo[:, :63], hi, nb, 64)
    with pytest.raises(ValueError, match="alike"):
        cuda(lo[0], hi[0], nb[0], 64)
    for ob in (-1, 1 << 31):
        with pytest.raises(ValueError, match="out_bytes"):
            cuda(lo, hi, nb, ob)
    with pytest.raises(ValueError, match="int64"):
        cuda(lo.int(), hi, nb, 64)
    with pytest.raises(ValueError, match="contiguous"):
        cuda(lo, hi.t().contiguous().t(), nb, 64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda(lo, hi, nb, 64)


def test_kernel_list_names_bitpack_and_its_build_raises_without_nvcc(
        monkeypatch, tmp_path):
    assert "bitpack" in _build.KERNELS
    assert (_build.CSRC / "bitpack.cu").exists()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_funcs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernel("bitpack")
    assert not (tmp_path / "build").exists() or \
        not list((tmp_path / "build").glob("*.so"))


# ---- the kernel's source on the host model (no card) --------------------
@pytest.mark.parametrize("R,T,kind", [
    (3, 700, "55-bit"), (2, 2048, "63-bit"), (2, 6000, "zero runs"),
    (3, 4096, "sparse"), (1, 1, "mixed"), (1, 3001, "mixed"),
    (4, 96, "sparse"), (2, 0, "mixed")])
def test_kernel_model_matches_plain_and_ref_pack(model, R, T, kind):
    lo, hi, nb = _tokens(R, T, kind, seed=T)
    out_bytes = int(nb.sum(1).max()) // 8 + 13      # odd: the byte path
    _check_model(model, lo, hi, nb, out_bytes, f"{kind} {R}x{T}", ref=True)
    _check_model(model, lo, hi, nb, out_bytes + 3, f"{kind} {R}x{T}")


@pytest.mark.parametrize("T", [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK - 4,
                               2 * CHUNK + 4, 3 * CHUNK + 7])
def test_kernel_model_matches_plain_at_chunk_boundaries(model, T):
    for kind in ("mixed", "63-bit", "sparse"):
        lo, hi, nb = _tokens(2, T, kind, seed=T + 1)
        _check_model(model, lo, hi, nb, int(nb.sum(1).max()) // 8 + 8,
                     f"{kind} T {T}")


def test_kernel_model_overflow_rows(model):
    """Rows past out_bytes: total_bits exact, the bytes the stream's
    prefix, nothing written past a row (the guard), at out_bytes that end
    inside a word and on one, with a row that fits between two that do
    not."""
    lo, hi, nb = _tokens(3, 3000, "mixed", seed=7)
    nb[1] = torch.where(torch.arange(3000) < 100, nb[1], 0)
    need = int(nb.sum(1).max()) // 8 + 1
    full = _ref_pack(lo, hi, nb, need)
    for ob in (1, 4, 37, 256, need // 2 + 1):
        want = (full[0][:, :ob].contiguous(), full[1])
        _assert_same(hierarchical_pack(lo, hi, nb, ob), want, f"plain {ob}")
        for vec, aligned in _flags(3000, ob):
            _assert_same(model(lo, hi, nb, ob, vec, aligned), want,
                         f"out_bytes {ob}, vec {vec}, aligned {aligned}")


@pytest.mark.parametrize("R,T,out_bytes", BODY + HEADERS + [SHARD])
def test_kernel_model_matches_plain_at_route_shapes(model, R, T, out_bytes):
    """The three call sites' shapes, on the path the launcher picks there:
    bodies at every bucket (the smaller ones overflow, as a group redone at
    a larger bucket does), headers and the sharded lanes."""
    lo, hi, nb = _tokens(R, T, "deflate" if T > deflate.HMAX else "mixed",
                         seed=out_bytes + T)
    _check_model(model, lo, hi, nb, out_bytes, f"{R}x{T} -> {out_bytes}",
                 every_path=False)


@pytest.fixture(scope="module")
def cpu_pack_calls():
    """The arguments of every pack_rows call of CPU compress calls: L6,
    L1 and Z_FIXED of two real files, and compress_multichip on two CPU
    shards at pigz's block size."""
    seen = []

    def record(lo, hi, nbits, out_bytes):
        seen.append((lo.clone(), hi.clone(), nbits.clone(), out_bytes))
        return hierarchical_pack(lo, hi, nbits, out_bytes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(deflate, "pack_rows", record)
        mp.setattr(sharded, "pack_rows", record)
        data = text() + pigz()[:1 << 18]
        for level, strategy in ((6, 0), (1, 0), (6, 4)):
            deflate.compress_cuda(data, level, strategy=strategy,
                                  device="cpu")
        sharded.compress_multichip(text(), ["cpu"] * 2, lane_block=1 << 17)
    return seen


def test_kernel_model_matches_plain_on_real_pack_calls(model,
                                                       cpu_pack_calls):
    shapes = {tuple(c[2].shape) for c in cpu_pack_calls}
    assert shapes == {(32, deflate.UNIT), (32, huffman.HDR_SLOTS),
                      (1, SHARD[1])}
    for k, (lo, hi, nb, ob) in enumerate(cpu_pack_calls):
        _check_model(model, lo, hi, nb, ob, f"call {k} {tuple(nb.shape)}")


# ---- the kernel on the card ---------------------------------------------
def _on_card(card, lo, hi, nbits, out_bytes):
    """pack_rows on `card`, asserting one launch."""
    n0 = bitpack_merge.launches
    out = pack_rows(lo.to(card), hi.to(card), nbits.to(card), out_bytes)
    torch.cuda.synchronize()
    assert bitpack_merge.launches == n0 + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("R,T,out_bytes", BODY + HEADERS + [SHARD])
def test_bitpack_kernel_matches_plain_on_card(card, R, T, out_bytes):
    lo, hi, nb = _tokens(R, T, "deflate" if T > deflate.HMAX else "mixed",
                         seed=out_bytes + T)
    want = hierarchical_pack(lo.to(card), hi.to(card), nb.to(card),
                             out_bytes)
    _assert_same(_on_card(card, lo, hi, nb, out_bytes),
                 tuple(w.cpu() for w in want), f"{R}x{T} -> {out_bytes}")


@pytest.mark.gpu
@pytest.mark.parametrize("T,out_bytes", [(1, 8), (CHUNK + 1, 4099),
                                         (3001, 37)])
def test_bitpack_kernel_matches_plain_on_card_edges(card, T, out_bytes):
    """A scalar-load row length, a byte-stored out_bytes and an overflow."""
    for kind in ("mixed", "63-bit", "sparse"):
        lo, hi, nb = _tokens(3, T, kind, seed=T)
        _assert_same(_on_card(card, lo, hi, nb, out_bytes),
                     hierarchical_pack(lo, hi, nb, out_bytes),
                     f"{kind} T {T} -> {out_bytes}")


@pytest.mark.gpu
@pytest.mark.parametrize("level,strategy", [(6, 0), (9, 0), (1, 0), (6, 4)])
def test_compress_cuda_streams_equal_plain_route_and_count_launches(
        card, monkeypatch, level, strategy):
    """compress_cuda of the smoke corpus with the kernel, then with the
    plain pack on the card: the same stream. Launches: 2 per L2-L9 lane
    group and redispatch (bodies, headers), 1 per quick-path group with a
    coded unit (one `_stage2_fixed` call)."""
    data, _ = chip_smoke.corpus()
    fixed = deflate._stage2_fixed
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return fixed(*a, **k)
    monkeypatch.setattr(deflate, "_stage2_fixed", counted)
    n0 = _build.launches["bitpack"]
    out = deflate.compress_cuda(data, level, strategy=strategy, device=card)
    launches = _build.launches["bitpack"] - n0
    st = dict(deflate.stage_seconds)
    assert st.get("bitpack.launches.n", 0) == launches
    if level > 1 and strategy != 4:
        groups = st["stage2.groups.n"] + st["stage2.redispatch.n"]
        assert launches == 2 * groups and calls == []
    else:
        assert launches == len(calls) > 0
    monkeypatch.setattr(deflate, "pack_rows", hierarchical_pack)
    n0 = _build.launches["bitpack"]
    assert deflate.compress_cuda(data, level, strategy=strategy,
                                 device=card) == out
    assert _build.launches["bitpack"] == n0


@pytest.mark.gpu
def test_compress_multichip_streams_equal_plain_route(card, monkeypatch):
    """compress_multichip over every card present, at pigz's block size:
    one launch per shard, and the plain pack's stream."""
    data, _ = chip_smoke.corpus()
    data = data[: 4 << 20]
    devs = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    n0 = _build.launches["bitpack"]
    out = sharded.compress_multichip(data, devs, lane_block=1 << 17)
    assert _build.launches["bitpack"] - n0 == len(devs)
    monkeypatch.setattr(sharded, "pack_rows", hierarchical_pack)
    assert sharded.compress_multichip(data, devs, lane_block=1 << 17) == out
