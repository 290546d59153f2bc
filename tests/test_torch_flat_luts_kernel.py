"""Decode phase A's flat-LUT kernel (`csrc/flat_luts.cu`) against its plain
version (`ops/inflate.py:_build_flat_luts_plain`), entry for entry, with no
tolerance.

`_build_flat_luts` routes by device: CPU tensors take the plain version,
CUDA tensors the kernel (or it raises), any other device raises. Without a
card the kernel's own source still runs: the C++ compiler builds it against
the host model in `tests/cuda_model/` (one fiber per CUDA thread,
`__syncthreads` a switch back to the scheduler), so the CPU tests hold the
kernel's arithmetic to the plain version too. Tests marked `gpu` run it on
the card. Lanes: the canonical tables of every block of stdlib zlib L1, L6
and L9 streams of the corpora, and a set of edge tables (fixed trees, one
code of length 1, incomplete and over-subscribed codes, all lengths 15,
every popcount of the mask from 0 to 15, masks that are not low bits,
padding lanes with mask 0), at B = 1, 3 and 16 and lut_cap 512, 4,096 and
32,768. This file imports nothing of JAX, so on a machine with a card and
no JAX it runs as
`python -m pytest --noconftest -m gpu tests/test_torch_flat_luts_kernel.py`.
"""
import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from zlibng_tpu_torch import _build
from zlibng_tpu_torch.huffman.encode import huffman_code_lengths
from zlibng_tpu_torch.ops import inflate as ti
from zlibng_tpu_torch.parallel import index
from zlibng_tpu_torch.stream.inflate_serial import (
    _S_HUFF, STREAM_END, TREES_DONE, RawInflater,
)

from torch_corpus import cve, pigz, raw_deflate, sample, text

MODEL = Path(__file__).resolve().parent / "cuda_model"
NSYMS = {"lit": 288, "dist": 30}      # the wave engine's padded widths
SHAPES = [(B, cap) for B in (1, 3, 16) for cap in (512, 4096, 32768)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The kernel of csrc/flat_luts.cu built with the host model: a function
    (tabs, masks, lut_cap) -> the (B, lut_cap) LUTs, on CPU tensors."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) for the kernel's host model")
    lib = tmp_path_factory.mktemp("flat_luts_model") / "flat_luts_model.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    f"-I{MODEL}", f"-I{_build.CSRC}",
                    str(MODEL / "flat_luts_model.cpp"), "-o", str(lib)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).zng_flat_luts_model
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    fn.restype = None

    def run(tabs, masks, lut_cap):
        B = tabs.shape[0]
        # -7 is no entry the kernel can write: an unwritten one shows
        out = torch.full((B, lut_cap), -7, dtype=torch.int32)
        fn(tabs.data_ptr(), masks.data_ptr(), out.data_ptr(), B,
           tabs.shape[1] - 48, lut_cap)
        return out
    return run


def _lane(packed: np.ndarray, mask: int, nsyms: int) -> tuple:
    """One lane as the wave engine lays it out: the packing zero-padded to
    48 + nsyms, and the mask as int32 bits."""
    row = np.zeros(48 + nsyms, np.int32)
    row[:packed.size] = packed
    return row, int(np.array(mask & 0xFFFFFFFF, np.uint32).view(np.int32))


def _canon(lengths, mask=None) -> tuple:
    """(_canon_tables packing, mask): (1 << max length) - 1 unless given."""
    lengths = np.asarray(lengths, np.int32)
    packed, w = ti._canon_tables(lengths, lengths.size)
    return packed, (1 << w) - 1 if mask is None else mask


@functools.lru_cache(maxsize=None)
def _edge_lanes(alphabet: str) -> tuple:
    """(tabs (L, 48 + nsyms), masks (L,)) int32: the edge tables."""
    n = NSYMS[alphabet]
    rng = np.random.default_rng(n)
    lit, dist = ti._fixed_canon()
    fixed = lit if alphabet == "lit" else dist
    lanes = [(fixed[0], (1 << fixed[1]) - 1)]
    one = np.zeros(n, np.int32)
    one[n - 2] = 1
    lanes.append(_canon(one))                           # one code, length 1
    inc = np.zeros(n, np.int32)
    inc[[0, 3, n - 1]] = (2, 2, 5)
    lanes.append(_canon(inc))                           # incomplete
    lanes.append(_canon(np.full(n, 15)))                # all lengths 15
    over = np.zeros(n, np.int32)
    over[[1, 2, 5]] = 1
    lanes.append(_canon(over))                          # over-subscribed
    # complete codes of random and skewed frequencies, one reaching 15 bits
    codes = []
    for k in range(6):
        f = rng.integers(0, 1000, n) if k < 3 else \
            (2.0 ** rng.uniform(0, 22, n)).astype(np.int64)
        f[rng.random(n) < 0.2 * (k % 3)] = 0
        codes.append(huffman_code_lengths(f, 15))
    fib = np.zeros(n, np.int64)
    fib[:2] = 1
    for i in range(2, 22):
        fib[i] = fib[i - 1] + fib[i - 2]
    codes.append(huffman_code_lengths(fib, 15))
    assert max(int(c.max()) for c in codes) == 15
    lanes += [_canon(c) for c in codes]
    # every popcount of the mask, over tables of other widths
    for w in range(16):
        lanes.append(_canon(codes[w % len(codes)], (1 << w) - 1))
    # masks that are not the low bits (popcount <= 15, sign bit included)
    for mask in (0x5555, 0x7FFF0000, 0x80000001, 0xF0F0):
        lanes.append(_canon(codes[-1], mask))
    lanes.append((np.zeros(48, np.int32), 0))           # a padding lane
    lanes.append((np.zeros(48, np.int32), 0))
    rows = [_lane(p, m, n) for p, m in lanes]
    return (torch.from_numpy(np.stack([r for r, _ in rows])),
            torch.tensor([m for _, m in rows], dtype=torch.int32))


def _block_tables(raw: bytes) -> list:
    """((lit packing, wl), (dist packing, wd)) of every Huffman block of a
    raw stream, in order, as the wave engine's _parse_header gives them."""
    inf = RawInflater()
    inf.feed(raw)
    out = []
    while True:
        inf._last_lengths = None
        r = inf.run(finish=True, stop="trees")
        if r == STREAM_END:
            return out
        if r == TREES_DONE and inf.state == _S_HUFF:
            if inf._last_lengths is None:           # a fixed block
                out.append(ti._fixed_canon())
                continue
            lengths, hlit, hdist = inf._last_lengths
            out.append((ti._canon_tables(lengths[:hlit], hlit),
                        ti._canon_tables(lengths[hlit:hlit + hdist], hdist)))


def _skewed(n: int) -> bytes:
    """Bytes of a Zipf-like law: literal codes of up to 14 bits."""
    rng = np.random.default_rng(15)
    return (rng.zipf(1.2, n) % 256).astype(np.uint8).tobytes()


@functools.lru_cache(maxsize=None)
def _stream_lanes(level: int) -> dict:
    """{alphabet: (tabs, masks)} of every block of stdlib zlib's raw
    streams of the corpora at `level`."""
    blocks = [t for d in (text(), sample("text", 400_000), cve(), pigz(),
                          _skewed(300_000))
              for t in _block_tables(raw_deflate(d, level))]
    out = {}
    for k, alphabet in enumerate(("lit", "dist")):
        rows = [_lane(p, (1 << w) - 1, NSYMS[alphabet])
                for p, w in (b[k] for b in blocks)]
        out[alphabet] = (torch.from_numpy(np.stack([r for r, _ in rows])),
                         torch.tensor([m for _, m in rows], dtype=torch.int32))
    return out


def _check_in_chunks(run, tabs, masks, B: int, lut_cap=None):
    """run(tabs, masks, lut_cap) on consecutive slices of B lanes (the lanes
    cycled to a multiple of B) against the plain version. lut_cap None:
    the wave engine's, max(512, 1 << the widest mask's popcount)."""
    n = -(-tabs.shape[0] // B) * B
    order = torch.arange(n) % tabs.shape[0]
    for k in range(0, n, B):
        i = order[k:k + B]
        t, m = tabs[i].contiguous(), masks[i].contiguous()
        cap = lut_cap or max(512, 1 << max(bin(v & 0xFFFFFFFF).count("1")
                                           for v in m.tolist()))
        want = ti._build_flat_luts_plain(t, m, cap)
        got = run(t, m, cap).cpu()
        assert got.dtype == want.dtype == torch.int32
        assert got.shape == want.shape == (B, cap)
        bad = (got != want).any(1).nonzero().flatten()
        assert bad.numel() == 0, \
            f"B {B}, lut_cap {cap}, lanes {i[bad].tolist()[:8]} differ"


# ---- the wrapper's routes (no card) -------------------------------------
@pytest.mark.parametrize("alphabet", ["lit", "dist"])
def test_build_flat_luts_routes_cpu_tensors_to_plain(alphabet):
    tabs, masks = _edge_lanes(alphabet)
    n0 = ti.launches
    got = ti._build_flat_luts(tabs, masks, 4096)
    assert torch.equal(got, ti._build_flat_luts_plain(tabs, masks, 4096))
    assert ti.launches == n0


def test_build_flat_luts_raises_off_cpu_and_cuda_and_on_bad_input():
    tabs, masks = _edge_lanes("dist")
    n0 = ti.launches
    with pytest.raises(ValueError, match="unsupported device"):
        ti._build_flat_luts(tabs.to("meta"), masks.to("meta"), 512)
    # the kernel's own checks that run without a card
    cuda = ti._build_flat_luts_cuda
    with pytest.raises(ValueError, match="int32"):
        cuda(tabs.long(), masks, 512)
    with pytest.raises(ValueError, match="int32"):
        cuda(tabs, masks.long(), 512)
    with pytest.raises(ValueError, match="contiguous"):
        cuda(tabs.t().contiguous().t(), masks, 512)
    with pytest.raises(ValueError, match=r"\(B, 48 \+ nsyms\)"):
        cuda(tabs[:, :48].contiguous(), masks, 512)
    with pytest.raises(ValueError, match=r"\(B, 48 \+ nsyms\)"):
        cuda(tabs, masks[1:].contiguous(), 512)
    with pytest.raises(ValueError, match=r"\(B, 48 \+ nsyms\)"):
        cuda(tabs[0].contiguous(), masks, 512)
    for cap in (0, (1 << 15) + 1):
        with pytest.raises(ValueError, match="lut_cap"):
            cuda(tabs, masks, cap)
    many = torch.zeros((65536, 49), dtype=torch.int32)
    with pytest.raises(ValueError, match="65535"):
        cuda(many, torch.zeros(65536, dtype=torch.int32), 512)
    with pytest.raises(ValueError, match="CUDA"):
        cuda(tabs, masks, 512)
    assert ti.launches == n0


def test_kernel_list_names_flat_luts_and_its_build_raises_without_nvcc(
        monkeypatch, tmp_path):
    assert "flat_luts" in _build.KERNELS
    assert (_build.CSRC / "flat_luts.cu").exists()
    sym, argtypes = _build._SIGNATURES["flat_luts"]
    assert sym == "zng_flat_luts" and len(argtypes) == 7
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_funcs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernel("flat_luts")
    assert not (tmp_path / "build").exists() or \
        not list((tmp_path / "build").glob("*.so"))


def test_edge_lanes_reach_every_outcome():
    """The edge tables are no vacuous test: their LUTs hold invalid entries
    and every code length 1-15, under masks of every popcount 0-15."""
    for alphabet in NSYMS:
        tabs, masks = _edge_lanes(alphabet)
        luts = ti._build_flat_luts_plain(tabs, masks, 1 << 15)
        lens = set((luts[luts >= 0] & 15).unique().tolist())
        assert (luts == -16).any() and lens == set(range(1, 16)), alphabet
    assert set(bin(m & 0xFFFFFFFF).count("1")
               for m in _edge_lanes("lit")[1].tolist()) == set(range(16))


# ---- the kernel's source on the host model (no card) --------------------
@pytest.mark.parametrize("alphabet", ["lit", "dist"])
@pytest.mark.parametrize("B,lut_cap", SHAPES)
def test_kernel_model_matches_plain_on_edge_tables(model, alphabet, B,
                                                   lut_cap):
    _check_in_chunks(model, *_edge_lanes(alphabet), B, lut_cap)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_kernel_model_matches_plain_on_stream_tables(model, level):
    """Every block's tables of stdlib zlib streams of the corpora, 16 lanes
    a launch at the wave engine's lut_cap."""
    lanes = _stream_lanes(level)
    for alphabet in NSYMS:
        _check_in_chunks(model, *lanes[alphabet], 16)


# ---- the kernel on the card ---------------------------------------------
def _on(card):
    """_build_flat_luts on `card`, asserting one launch per call."""
    def run(tabs, masks, lut_cap):
        n0 = ti.launches
        out = ti._build_flat_luts(tabs.to(card), masks.to(card), lut_cap)
        assert ti.launches == n0 + 1 and out.device.type == "cuda"
        return out
    return run


def _plain_on(card):
    """The plain version on the card: the kernel's twin on the same
    device, against the CPU's plain version."""
    def run(tabs, masks, lut_cap):
        return ti._build_flat_luts_plain(tabs.to(card), masks.to(card),
                                         lut_cap)
    return run


@pytest.mark.gpu
@pytest.mark.parametrize("alphabet", ["lit", "dist"])
@pytest.mark.parametrize("B,lut_cap", SHAPES)
def test_flat_luts_kernel_matches_plain_on_card(card, alphabet, B, lut_cap):
    _check_in_chunks(_on(card), *_edge_lanes(alphabet), B, lut_cap)
    _check_in_chunks(_plain_on(card), *_edge_lanes(alphabet), B, lut_cap)


@pytest.mark.gpu
@pytest.mark.parametrize("level", [1, 6, 9])
def test_flat_luts_kernel_matches_plain_on_stream_tables_on_card(card,
                                                                 level):
    lanes = _stream_lanes(level)
    for alphabet in NSYMS:
        tabs, masks = lanes[alphabet]
        _check_in_chunks(_on(card), tabs, masks, 16)
        _check_in_chunks(_on(card), tabs, masks, tabs.shape[0], 1 << 15)


@pytest.mark.gpu
def test_indexed_decode_on_card_builds_luts_in_two_launches_a_dispatch(card):
    """decompress_indexed_cuda on the card: the input back, and the kernel
    launched once per table of every phase A dispatch, counted both by the
    wrapper and by the call's `phase_a.luts.launches` counter."""
    data = pigz() + sample("a16", 100000) + text() + _skewed(200000)
    blob, idx = chip_smoke.indexed_blob(data, 1 << 17)
    ok, n0 = ti.stats["device_ok"], ti.launches
    assert index.decompress_indexed_cuda(blob, idx, device=card) == data
    assert ti.stats["device_ok"] == ok + 1
    st = ti.decode_stats
    assert st["phase_a"] > 0
    assert st["phase_a.luts.launches"] == 2 * st["phase_a"]
    assert ti.launches - n0 == st["phase_a.luts.launches"]
