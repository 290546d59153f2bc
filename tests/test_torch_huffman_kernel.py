"""Stage 2's Huffman kernel (`csrc/huffman.cu`) against its plain version
(`ops/huffman.py`: huff_table of each alphabet, then dyn_header), every
output slot for slot, with no tolerance.

`huff_build` routes by device: CPU tensors take the plain loops, CUDA
tensors the kernel (or it raises), any other device raises. Without a card
the kernel's own source still runs: the C++ compiler builds it against the
host model in `tests/cuda_model/` (one std::thread per CUDA thread,
`__syncthreads` a barrier), so the CPU tests hold the kernel's arithmetic
to the plain version too. Tests marked `gpu` run it on the card. Rows:
`torch_corpus.freq_cases` (adversarial and random) and the rows of real L6
compress calls, at G = 1, 33 and 128. This file imports nothing of JAX, so
on a machine with a card and no JAX it runs as
`python -m pytest --noconftest -m gpu tests/test_torch_huffman_kernel.py`.
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
from zlibng_tpu_torch.format.constants import MAX_BITS
from zlibng_tpu_torch.ops import huffman

from torch_corpus import freq_cases, pigz, text

OUTS = ("llen", "lcode", "dlen", "dcode", "hdr_lo", "hdr_nb", "hdr_bits")
MODEL = Path(__file__).resolve().parent / "cuda_model"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The kernel of csrc/huffman.cu built with the host model: a function
    (lfreq, dfreq, btype_bits) -> huff_build's seven outputs, on CPU
    tensors."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) for the kernel's host model")
    lib = tmp_path_factory.mktemp("huffman_model") / "huffman_model.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    f"-I{MODEL}", f"-I{_build.CSRC}",
                    str(MODEL / "huffman_model.cpp"), "-o", str(lib)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).zng_huff_build_model
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
    fn.restype = None

    def run(lfreq, dfreq, btype_bits=4):
        G = lfreq.shape[0]
        out = _sentinels(G, "cpu")
        fn(lfreq.data_ptr(), dfreq.data_ptr(),
           *[t.data_ptr() for t in out], G, btype_bits)
        return out
    return run


def _sentinels(G: int, dev) -> tuple:
    """Outputs of huff_build's shapes and types, every element -7: an
    element the kernel leaves unwritten shows."""
    shapes = ((G, 286), (G, 286), (G, 30), (G, 30),
              (G, huffman.HDR_SLOTS), (G, huffman.HDR_SLOTS), (G,))
    dtypes = (torch.int32,) * 4 + (torch.int64, torch.int32, torch.int32)
    return tuple(torch.full(s, -7, dtype=d, device=dev)
                 for s, d in zip(shapes, dtypes))


def _plain(lfreq, dfreq, btype_bits=4) -> tuple:
    """The plain version on CPU copies, step by step."""
    lf, df = lfreq.cpu(), dfreq.cpu()
    llen, lcode = huffman.huff_table(lf, MAX_BITS)
    dlen, dcode = huffman.huff_table(df, MAX_BITS)
    return (llen, lcode, dlen, dcode,
            *huffman.dyn_header(llen, dlen, btype_bits))


def _assert_same(got, want, what: str) -> None:
    assert len(got) == len(want) == len(OUTS)
    for name, a, b in zip(OUTS, got, want):
        a = a.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        bad = (a != b).reshape(a.shape[0], -1).any(1).nonzero()
        assert bad.numel() == 0, \
            f"{what}: {name} differs in rows {bad.flatten()[:8].tolist()}"


def _case_rows(n_rows: int = 128):
    """n_rows rows of (lit, dist) frequencies: freq_cases of each alphabet,
    cycled, the distance cases paired at an offset."""
    L = freq_cases(286, seed=286)
    D = freq_cases(30, seed=30)
    i = np.arange(n_rows)
    return (torch.from_numpy(L[i % len(L)]),
            torch.from_numpy(D[(7 * i + 3) % len(D)]))


def _check_in_chunks(run, lfreq, dfreq, G: int, btype_bits: int = 4):
    """run(lf, df, btype_bits) on consecutive slices of G rows (the rows
    cycled to a multiple of G) against the plain version of all rows (a
    row's tables and header depend on that row alone)."""
    want = _plain(lfreq, dfreq, btype_bits)
    n = -(-lfreq.shape[0] // G) * G
    order = torch.arange(n) % lfreq.shape[0]
    for k in range(0, n, G):
        i = order[k:k + G]
        got = run(lfreq[i].contiguous(), dfreq[i].contiguous(), btype_bits)
        _assert_same(got, tuple(w[i] for w in want),
                     f"G {G}, rows {k}-{k + G - 1}")


@pytest.fixture(scope="module")
def cpu_l6_rows():
    """The lane groups' rows of CPU L6 compress calls of two real files."""
    seen = [g for d in (pigz(), text())
            for g in chip_smoke.huffman_groups(d, "cpu")]
    return (torch.cat([g[0] for g in seen]), torch.cat([g[1] for g in seen]))


# ---- the wrapper's routes (no card) -------------------------------------
def test_huff_build_routes_cpu_tensors_to_plain():
    lf, df = _case_rows(40)
    n0 = huffman.launches
    for bt in (4, 5):
        _assert_same(huffman.huff_build(lf, df, bt), _plain(lf, df, bt),
                     f"btype_bits {bt}")
    assert huffman.launches == n0


def test_huff_build_raises_off_cpu_and_cuda_and_on_bad_cuda_input():
    lf, df = _case_rows(2)
    with pytest.raises(ValueError, match="unsupported device"):
        huffman.huff_build(lf.to("meta"), df.to("meta"), 4)
    # the kernel's own checks that run without a card
    with pytest.raises(ValueError, match="int32"):
        huffman._huff_build_cuda(lf.long(), df.long(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        huffman._huff_build_cuda(lf.t().contiguous().t(), df, 4)
    with pytest.raises(ValueError, match="CUDA"):
        huffman._huff_build_cuda(lf, df, 4)


def test_kernel_list_names_huffman_and_its_build_raises_without_nvcc(
        monkeypatch, tmp_path):
    assert "huffman" in _build.KERNELS
    assert (_build.CSRC / "huffman.cu").exists()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_funcs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernel("huffman")
    assert not (tmp_path / "build").exists() or \
        not list((tmp_path / "build").glob("*.so"))


# ---- the kernel's source on the host model (no card) --------------------
@pytest.mark.parametrize("G,btype_bits", [(1, 4), (33, 5), (128, 4)])
def test_kernel_model_matches_plain_on_cases(model, G, btype_bits):
    _check_in_chunks(model, *_case_rows(), G, btype_bits)


@pytest.mark.parametrize("G", [1, 33, 128])
def test_kernel_model_matches_plain_on_real_l6_rows(model, cpu_l6_rows, G):
    _check_in_chunks(model, *cpu_l6_rows, G)


# ---- the kernel on the card ---------------------------------------------
def _on(card):
    """huff_build on `card`, asserting one launch per call."""
    def run(lfreq, dfreq, btype_bits):
        n0 = huffman.launches
        out = huffman.huff_build(lfreq.to(card), dfreq.to(card), btype_bits)
        assert huffman.launches == n0 + 1
        return out
    return run


@pytest.mark.gpu
@pytest.mark.parametrize("G,btype_bits", [(1, 4), (33, 5), (128, 4)])
def test_huffman_kernel_matches_plain_on_card(card, G, btype_bits):
    _check_in_chunks(_on(card), *_case_rows(), G, btype_bits)


@pytest.mark.gpu
def test_huffman_kernel_matches_plain_on_real_l6_rows_on_card(card):
    """The rows of an L6 compress of chip_smoke.py's corpus on the card
    (four groups of 128 rows and a tail of 32): the outputs the call used,
    then the same rows again at G = 1, 33 and 128."""
    data, _ = chip_smoke.corpus()
    n0 = huffman.launches
    seen = chip_smoke.huffman_groups(data, card)
    assert huffman.launches == n0 + len(seen)
    assert sorted({g[0].shape[0] for g in seen}) == [32, 128]
    for k, (lf, df, bt, out) in enumerate(seen):
        _assert_same(out, _plain(lf, df, bt), f"group {k}")
    lf = torch.cat([g[0].cpu() for g in seen])
    df = torch.cat([g[1].cpu() for g in seen])
    for G in (1, 33, 128):
        _check_in_chunks(_on(card), lf, df, G)
