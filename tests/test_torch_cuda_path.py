"""The PyTorch port's routing: the slice's limits raise NotImplementedError,
a CUDA request never carries on on the CPU, wrappers route by tensor
device, and the kernel build raises when it cannot run. Tests marked `gpu`
hold the CUDA kernels against their plain versions and the card's output
against the CPU's; without a card they skip. This file imports nothing of
JAX, so on a machine with a card and no JAX it runs as
`python -m pytest --noconftest -m gpu tests/test_torch_cuda_path.py`."""
import inspect
import zlib
from types import SimpleNamespace

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


@pytest.mark.parametrize("kwargs,what", [
    (dict(level=1), "quick path"),
    (dict(level=6, strategy=4), "quick path"),
    (dict(level=0), "host encoder"),
    (dict(level=6, tune=SimpleNamespace(chain=128, lazy=True, max_lazy=64,
                                        nice=258, good=12)), "deep probes"),
])
def test_outside_the_slice_raises(kwargs, what):
    with pytest.raises(NotImplementedError, match=what):
        compress_cuda(sample("text", 5000), device="cpu", **kwargs)


def test_small_input_and_bad_wbits_raise():
    with pytest.raises(NotImplementedError, match="host encoder"):
        compress_cuda(b"x" * 1023, 6, device="cpu")
    with pytest.raises(StreamError):
        compress_cuda(b"x" * 4096, 6, wbits=32, device="cpu")


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    assert inspect.signature(compress_cuda).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (probe.launches, parse.launches)
    with pytest.raises(RuntimeError, match="cuda"):
        zlibng_tpu_torch.compress_cuda(sample("text", 5000), 6)
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
    for dense in (4, 16, 24, 64):
        for max_dist in (512, 32768):
            args = (w2_s, h_s, pos_s, hv, dense, 16, 12, max_dist)
            n0 = probe.launches
            ks, kc = probe.probe_best(*args)
            assert probe.launches == n0 + 1
            ps, pc = probe._probe_best_plain(*args)
            assert torch.equal(ks, ps) and torch.equal(kc, pc)


@pytest.mark.gpu
def test_parse_kernel_matches_plain_on_card(card):
    rng = np.random.default_rng(0)
    is_m = rng.random((5, 5000)) < 0.3
    step = torch.from_numpy(np.where(is_m, rng.integers(3, 259, (5, 5000)),
                                     1).astype(np.int32)).to(card)
    bounds = torch.tensor([[0, 5000], [10, 4000], [4999, 5000], [7, 7],
                           [100, 5000]], dtype=torch.int32, device=card)
    for s in (step, parse.fused_steps(step)):
        assert torch.equal(parse.parse_select(s, bounds),
                           parse._parse_select_plain(s, bounds))


@pytest.mark.gpu
@pytest.mark.parametrize("level", [6, 9])
def test_compress_on_card_matches_cpu(card, level):
    data = pigz()[:300000]
    n0 = (probe.launches, parse.launches)
    got = compress_cuda(data, level, device=card)
    assert probe.launches > n0[0] and parse.launches > n0[1]
    assert got == compress_cuda(data, level, device="cpu")
    assert zlib.decompress(got) == data
