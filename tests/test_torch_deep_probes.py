"""The compacted deep probes of the PyTorch port (tune chains beyond the 64
dense probes) against the JAX package.

`lz77_lane` must give equal step/take/blen/bdist at chains 65, 128 and 258
with a `good` gate, a history bound > 0 and per-lane encode ends; and
`compress_cuda` with a chain-128 tune must give `compress_tpu`'s bytes.
`probe_best(..., chain, enc_start, enc_end)`, which on the card takes the
dense and the deep probes in one K1 launch, must equal on the CPU the
plain sweep followed by `deep_probes` at chains 1 to 1024. Tolerance: none.
"""
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zlibng_tpu.ops import lz77_jax as ref
from zlibng_tpu.ops.deflate_tpu import compress_tpu
from zlibng_tpu.stream.deflate import LevelConfig
from zlibng_tpu_torch import compress_cuda
from zlibng_tpu_torch.ops import lz77 as tlz
from zlibng_tpu_torch.ops import probe as tprobe

from torch_corpus import sample

N = 12288
ENC_START = 4096
UNIT = 4096
# a two-symbol alphabet gives same-hash runs far longer than 64 rows whose
# probes stay short, so the deep probes have rows to serve
KINDS = ("a2", "text", "a4")
ENC_END = np.array([N, N - 333, 9000], np.int32)
HV = np.array([1000, 0, 4096], np.int32)


def _lanes() -> np.ndarray:
    return np.stack([np.frombuffer(sample(k, N, seed=7), np.uint8)
                     for k in KINDS])


@pytest.mark.parametrize("chain,good", [(65, 12), (128, 8), (258, 16)])
def test_lz77_lane_deep_probes_match_reference(chain, good):
    data = _lanes()
    fn = jax.jit(jax.vmap(lambda d, e, h: ref.lz77_lane(
        d, jnp.int32(ENC_START), e, h, chain, True, 32, 258, unit=UNIT,
        good=good)))
    want = {k: np.asarray(v) for k, v in fn(
        jnp.asarray(data), jnp.asarray(ENC_END), jnp.asarray(HV)).items()}
    tlz.deep_stats.update(rows=0, chunks=0)
    got = tlz.lz77_lane(torch.from_numpy(data), ENC_START,
                        torch.from_numpy(ENC_END), torch.from_numpy(HV),
                        chain, True, 32, 258, unit=UNIT, good=good)
    for k in ("step", "take", "blen", "bdist"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert tlz.deep_stats["rows"] > 0
    assert tlz.deep_stats["k_steps"] == chain - tlz.DENSE_PROBES


@pytest.mark.parametrize("rows", [1, 37, 500])
def test_deep_probes_in_many_chunks_match_reference(monkeypatch, rows):
    """Chunks of a few needy rows (the card's run takes 28 chunks of
    16,384 rows) give the reference's arrays, and the row count and the
    chunk count agree with the chunk size."""
    chain, good = 128, 12
    data = _lanes()
    fn = jax.jit(jax.vmap(lambda d, e, h: ref.lz77_lane(
        d, jnp.int32(ENC_START), e, h, chain, True, 32, 258, unit=UNIT,
        good=good)))
    want = {k: np.asarray(v) for k, v in fn(
        jnp.asarray(data), jnp.asarray(ENC_END), jnp.asarray(HV)).items()}
    monkeypatch.setattr(tlz, "_DEEP_PAIRS", rows * (chain - tlz.DENSE_PROBES))
    tlz.deep_stats.update(rows=0, chunks=0)
    got = tlz.lz77_lane(torch.from_numpy(data), ENC_START,
                        torch.from_numpy(ENC_END), torch.from_numpy(HV),
                        chain, True, 32, 258, unit=UNIT, good=good)
    for k in ("step", "take", "blen", "bdist"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    n = tlz.deep_stats["rows"]
    assert tlz.deep_stats["chunks"] == -(-n // rows) > 1


def test_deep_probes_change_the_result():
    """The deep probes are not a no-op on these lanes: chain 128 finds
    matches that the dense 64 probes do not."""
    data = torch.from_numpy(_lanes())
    args = (data, ENC_START, torch.from_numpy(ENC_END),
            torch.from_numpy(HV))
    deep = tlz.lz77_lane(*args, 128, True, 32, 258, unit=UNIT, good=32)
    dense = tlz.lz77_lane(*args, 64, True, 32, 258, unit=UNIT, good=32)
    assert not torch.equal(deep["bdist"], dense["bdist"])


@pytest.mark.parametrize("chain", [128, 258])
def test_compress_with_deep_tune_byte_identical(chain):
    data = sample("text", 30000) + sample("a4", 20000, seed=3)
    tune = LevelConfig(chain, True, 258, 258, good=12)
    want = compress_tpu(data, 6, tune=tune)
    got = compress_cuda(data, 6, tune=SimpleNamespace(
        chain=chain, lazy=True, max_lazy=258, nice=258, good=12),
        device="cpu")
    assert got == want
    assert zlib.decompress(got) == data


@pytest.mark.parametrize("chain", [1, 2, 16, 40, 64, 65, 128, 1024])
def test_probe_best_with_chain_equals_two_calls(chain):
    """probe_best(..., chain, enc_start, enc_end) on CPU tensors (one call,
    as K1 takes the dense and the deep probes in one launch on the card)
    equals the plain sweep followed by deep_probes."""
    data = torch.from_numpy(_lanes())
    pad = torch.cat([data, torch.zeros((3, 16), dtype=torch.uint8)], 1)
    w2_s, h_s, pos_s, _ = tlz.sorted_probe_rows(tlz._build_w4(pad), N)
    hv, enc_end = torch.from_numpy(HV), torch.from_numpy(ENC_END)
    dense, good = min(chain, tlz.DENSE_PROBES), 12
    want_s, want_c = tprobe._probe_best_plain(w2_s, h_s, pos_s, hv, dense,
                                              tlz.GATE_DEPTH, good)
    if chain > dense:
        tlz.deep_probes(w2_s, h_s, pos_s, hv, want_s, want_c, ENC_START,
                        enc_end.reshape(-1, 1), dense, chain, good)
    got_s, got_c = tprobe.probe_best(w2_s, h_s, pos_s, hv, dense,
                                     tlz.GATE_DEPTH, good, chain=chain,
                                     enc_start=ENC_START, enc_end=enc_end)
    assert torch.equal(got_s, want_s) and torch.equal(got_c, want_c)
    if chain > dense:     # the deep probes moved some row
        base, _ = tprobe.probe_best(w2_s, h_s, pos_s, hv, dense,
                                    tlz.GATE_DEPTH, good)
        assert not torch.equal(got_s, base)


def test_probe_best_argument_checks():
    w = torch.zeros((1, 64, 4), dtype=torch.int32)
    h = torch.zeros((1, 64), dtype=torch.int32)
    hv = torch.zeros(1, dtype=torch.int32)
    end = torch.full((1,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_end"):
        tprobe.probe_best(w, h, h, hv, 64, 16, 12, chain=128)
    with pytest.raises(ValueError, match="good_l16"):
        tprobe.probe_best(w, h, h, hv, 64, 16, 20, chain=128, enc_end=end)
    with pytest.raises(ValueError, match="dense"):
        tprobe.probe_best(w, h, h, hv, 16, 16, 12, chain=8)
    s, c = tprobe.probe_best(w, h, h, hv, 0, 16, 12, chain=0)
    assert (s == tprobe.NEG).all() and (c == 0).all()
