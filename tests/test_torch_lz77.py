"""Stage-1 LZ77 of the PyTorch port against the JAX package.

`lz77_lane` (batched over lanes in the port, vmapped in the reference)
must give equal step/take/blen/bdist at the L2, L6 and L9 settings and
for strategies 1-3 (filtered, huffman-only, rle), with a history bound
> 0, a unit cap and a window bound. The arithmetic code mappings are
checked over their whole domains. Tolerance: none.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zlibng_tpu.ops import lz77_jax as ref
from zlibng_tpu.stream.deflate import LEVELS as REF_LEVELS
from zlibng_tpu_torch.ops import lz77 as tlz
from zlibng_tpu_torch.ops import probe as tprobe

from torch_corpus import sample

N = 12288
ENC_START = 4096
UNIT = 4096
KINDS = ("pigz", "text", "runs", "a16")
ENC_END = np.array([N, N - 333, N, 6000], np.int32)
HV = np.array([1000, 0, 4096, 0], np.int32)


def _lanes() -> np.ndarray:
    return np.stack([np.frombuffer(sample(k, N, seed=4), np.uint8)
                     for k in KINDS])


def _ref_lane(data, lc, strategy, max_dist):
    fn = jax.jit(jax.vmap(
        lambda d, e, h: ref.lz77_lane(
            d, jnp.int32(ENC_START), e, h, lc.chain, lc.lazy, lc.max_lazy,
            lc.nice, unit=UNIT, strategy=strategy, good=lc.good,
            max_dist=max_dist)))
    out = fn(jnp.asarray(data), jnp.asarray(ENC_END), jnp.asarray(HV))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("level,strategy,max_dist", [
    (2, 0, 32768), (6, 0, 32768), (9, 0, 4096),
    (6, 1, 32768), (6, 2, 32768), (6, 3, 512),
])
def test_lz77_lane_matches_reference(level, strategy, max_dist):
    lc = REF_LEVELS[level]
    data = _lanes()
    want = _ref_lane(data, lc, strategy, max_dist)
    got = tlz.lz77_lane(torch.from_numpy(data), ENC_START,
                        torch.from_numpy(ENC_END), torch.from_numpy(HV),
                        lc.chain, lc.lazy, lc.max_lazy, lc.nice, unit=UNIT,
                        strategy=strategy, good=lc.good, max_dist=max_dist)
    for k in ("step", "take", "blen", "bdist"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert int(want["take"].sum()) > 0 or strategy == 2


def test_code_arithmetic_matches_reference():
    lengths = np.arange(3, 259, dtype=np.int32)
    dists = np.arange(1, 32769, dtype=np.int32)
    for rf, tf, x in ((ref.length_code_arith, tlz.length_code_arith, lengths),
                      (ref.dist_code_arith, tlz.dist_code_arith, dists)):
        np.testing.assert_array_equal(tf(torch.from_numpy(x)).numpy(),
                                      np.asarray(rf(jnp.asarray(x))))
    for rf, tf, x in ((ref.length_extra_arith, tlz.length_extra_arith,
                       lengths),
                      (ref.dist_extra_arith, tlz.dist_extra_arith, dists)):
        for g, w in zip(tf(torch.from_numpy(x)), rf(jnp.asarray(x))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = np.arange(1, 1 << 20, 37, dtype=np.int32)
    np.testing.assert_array_equal(tlz._floor_log2(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref._floor_log2(jnp.asarray(x))))


def test_word_hash_and_byte_ctz_match_reference():
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, 5000, dtype=np.uint8)
    w4 = tlz._build_w4(torch.from_numpy(raw))
    w4_ref = np.asarray(ref._build_w4(jnp.asarray(raw)))
    np.testing.assert_array_equal(w4.numpy(), w4_ref.astype(np.int64))
    np.testing.assert_array_equal(
        tlz._hash_w4(w4).numpy(),
        ((w4_ref.astype(np.uint64) * np.uint64(ref.HASH_MULT))
         & np.uint64(0xFFFFFFFF)) >> np.uint64(16))
    words = np.concatenate([
        rng.integers(0, 1 << 32, 4000, dtype=np.uint64),
        np.uint64(1) << np.arange(32, dtype=np.uint64),
        np.array([0, 0xFFFFFFFF, 0x80000000], np.uint64)]).astype(np.uint32)
    want = np.asarray(ref._ctz_bytes32(jnp.asarray(words)))
    np.testing.assert_array_equal(
        tprobe._ctz_bytes32(torch.from_numpy(words.view(np.int32))).numpy(),
        want)
    np.testing.assert_array_equal(
        tprobe._ctz_bytes32(torch.from_numpy(words.astype(np.int64))).numpy(),
        want)

