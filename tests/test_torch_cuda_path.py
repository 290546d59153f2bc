"""The PyTorch port's routing: a CUDA request never carries on on the CPU
(not even for the host encoder's inputs), wrappers route by tensor device,
and the kernel build raises when it cannot run. Tests marked `gpu` hold
the CUDA kernels against their plain versions and the card's output
against the CPU's; without a card they skip. This file imports nothing of
JAX, so on a machine with a card and no JAX it runs as
`python -m pytest --noconftest -m gpu tests/test_torch_cuda_path.py`."""
import inspect
import zlib

import numpy as np
import pytest
import torch

import zlibng_tpu_torch
from zlibng_tpu_torch import _build, compress_cuda
from zlibng_tpu_torch.errors import StreamError
from zlibng_tpu_torch.ops import lz77, parse, probe

from torch_corpus import pigz, sample


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def test_small_input_and_bad_wbits_raise():
    """Small inputs run (on the host encoder); bad wbits raise."""
    assert zlib.decompress(compress_cuda(b"x" * 1023, 6, device="cpu")) \
        == b"x" * 1023
    with pytest.raises(StreamError):
        compress_cuda(b"x" * 4096, 6, wbits=32, device="cpu")


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    assert inspect.signature(compress_cuda).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (probe.launches, parse.launches)
    with pytest.raises(RuntimeError, match="cuda"):
        zlibng_tpu_torch.compress_cuda(sample("text", 5000), 6)
    # the host encoder's inputs too: the device is checked first
    with pytest.raises(RuntimeError, match="cuda"):
        compress_cuda(sample("text", 5000), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        compress_cuda(b"x")
    assert (probe.launches, parse.launches) == before


def test_wrappers_route_by_device():
    before = (probe.launches, parse.launches)
    step = torch.ones((1, 64), dtype=torch.int32)
    bounds = torch.tensor([[0, 64]], dtype=torch.int32)
    assert bool(parse.parse_select(step, bounds).all())
    w = torch.zeros((1, 64, 4), dtype=torch.int32)
    s, _ = probe.probe_best(w, step, step, torch.zeros(1, dtype=torch.int32),
                            4, 16, 12)
    assert s.shape == (1, 64)
    assert (probe.launches, parse.launches) == before   # CPU: plain only
    with pytest.raises(ValueError):
        parse.parse_select(step.to("meta"), bounds.to("meta"))
    with pytest.raises(ValueError):
        probe.probe_best(w.to("meta"), step.to("meta"), step.to("meta"),
                         torch.zeros(1, dtype=torch.int32, device="meta"),
                         4, 16, 12)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_funcs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernel("probe")
    assert not (tmp_path / "build").exists() or \
        not list((tmp_path / "build").glob("*.so"))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 4])
def test_probe_kernel_matches_plain_on_card(card, W):
    rng = np.random.default_rng(W)
    lanes = torch.from_numpy(np.stack([
        np.frombuffer(sample("pigz", 9000), np.uint8),
        rng.integers(0, 8, 9000, dtype=np.uint8)])).to(card)
    pad = torch.cat([lanes, lanes.new_zeros((2, 16))], 1)
    w2_s, h_s, pos_s, _ = lz77.sorted_probe_rows(lz77._build_w4(pad), 9000)
    w2_s = w2_s[..., :W].contiguous()
    hv = torch.tensor([100, 0], dtype=torch.int32, device=card)
    for dense in (2, 4, 16, 24, 64):
        for max_dist in (512, 32768):
            args = (w2_s, h_s, pos_s, hv, dense, 16, 12, max_dist)
            n0 = probe.launches
            ks, kc = probe.probe_best(*args)
            assert probe.launches == n0 + 1
            ps, pc = probe._probe_best_plain(*args)
            assert torch.equal(ks, ps) and torch.equal(kc, pc)


def _parse_card_steps(n: int) -> dict:
    """Random literal/match steps and the arrays that defeat the segmented
    walk's speculation or test its step arithmetic, as (8, n) int32."""
    rng = np.random.default_rng(0)
    shape = (8, n)
    lit_match = np.where(rng.random(shape) < 0.3,
                         rng.integers(3, 259, shape), 1)
    rare = rng.random(shape) < 0.002
    neg = rng.integers(-2 ** 31, 0, shape, dtype=np.int64)
    return {
        "random": lit_match,
        "all-3": np.full(shape, 3),
        "all-258": np.full(shape, 258),
        "all-literal fused": (n - np.arange(n))[None].repeat(8, 0),
        "zeros": np.zeros(shape),
        "negative": np.where(rng.random(shape) < 0.5, neg, lit_match),
        "1<<26": np.where(rare, 1 << 26, lit_match),
        "2**31-1": np.where(rare, 2 ** 31 - 1, lit_match),
        "all 2**31-1": np.full(shape, 2 ** 31 - 1),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5000, 20000])
def test_parse_kernel_matches_plain_on_card(card, n):
    S = parse.SEG
    bounds = torch.tensor([[0, n], [10, n - 1000], [n - 1, n], [7, 7],
                           [100, n], [S + 953, 2 * S - 49], [0, 0],
                           [S - 1, S + 1]], dtype=torch.int32, device=card)
    steps = {k: torch.from_numpy(a.astype(np.int32)).to(card)
             for k, a in _parse_card_steps(n).items()}
    for kind, step in steps.items():
        for s in (step, parse.fused_steps(step)):
            # leave a freed block of sel's size full of 0xAB for it to reuse
            torch.full((8, n), 0xAB, dtype=torch.uint8, device=card)
            n0 = parse.launches
            got = parse.parse_select(s, bounds)
            assert parse.launches == n0 + 1
            assert got.dtype == torch.bool
            assert int(got.view(torch.uint8).max()) <= 1, kind
            assert torch.equal(got, parse._parse_select_plain(s, bounds)), \
                kind


@pytest.mark.gpu
@pytest.mark.parametrize("level", [6, 9])
def test_compress_on_card_matches_cpu(card, level):
    data = pigz()[:300000]
    n0 = (probe.launches, parse.launches)
    got = compress_cuda(data, level, device=card)
    assert probe.launches > n0[0] and parse.launches > n0[1]
    assert got == compress_cuda(data, level, device="cpu")
    assert zlib.decompress(got) == data


@pytest.mark.gpu
@pytest.mark.parametrize("level,strategy", [(1, 0), (6, 4)])
def test_quick_path_on_card_matches_cpu(card, level, strategy):
    data = pigz()[:300000] + sample("a256", 20000)
    n0 = (probe.launches, parse.launches)
    got = compress_cuda(data, level, strategy=strategy, device=card)
    assert probe.launches > n0[0] and parse.launches > n0[1]
    assert got == compress_cuda(data, level, strategy=strategy, device="cpu")
    assert zlib.decompress(got) == data
