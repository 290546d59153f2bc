"""K1 (probe sweep) of the PyTorch port against the JAX package.

The port's plain version (`zlibng_tpu_torch.ops.probe._probe_best_plain`,
the path a CPU tensor takes) must equal `lz77_jax._probe_best_xla` and the
Pallas kernel `probe_best_pallas` run in interpret mode, for every
(dense, gate, good) setting the levels use, 2- and 4-word probes, three
window sizes and a history bound > 0. Tolerance: none (integer outputs).
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda_path.py, chip_smoke.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zlibng_tpu.ops.lz77_jax import HASH_MULT, _build_w4, _probe_best_xla
from zlibng_tpu.ops.probe_pallas import probe_best_pallas
from zlibng_tpu_torch.ops import lz77 as tlz
from zlibng_tpu_torch.ops import probe as tprobe

from torch_corpus import sample

CASES = [
    (2, 16, 8),     # L1
    (16, 16, 12),   # L6
    (32, 16, 12),   # L7 (gated tail)
    (64, 16, 12),   # L9 (gated tail)
    (64, 16, 4),    # aggressive good cut
    (64, 16, 16),   # good off (hunt everything)
]
N = 2048
# one XLA compile per setting instead of one per shifted shape
_xla = jax.jit(_probe_best_xla, static_argnames=(
    "dense", "gate_depth", "good_l16", "max_dist"))


def _jax_rows(data: np.ndarray, W: int):
    """The reference's probe-input construction for one lane
    (lz77_jax.lz77_lane): sorted probe words, hashes and positions."""
    n = data.shape[0]
    pad = jnp.concatenate([jnp.asarray(data), jnp.zeros(64, jnp.uint8)])
    w4 = _build_w4(pad)
    h = ((w4[:n] * jnp.uint32(HASH_MULT)) >> jnp.uint32(16)).astype(jnp.int32)
    order = jnp.argsort(h, stable=True).astype(jnp.int32)
    w2 = jnp.stack([w4[4 * i: n + 4 * i] for i in range(W)], axis=1)
    return w2[order], h[order], order


def _lane(kind: str) -> np.ndarray:
    if kind == "text":
        return np.frombuffer(sample("pigz", N), np.uint8)
    return np.frombuffer(sample("a8", N, seed=3), np.uint8)


def _port(w2_s, h_s, pos_s, hv, dense, gate, good, max_dist):
    s, c = tprobe.probe_best(
        torch.from_numpy(np.array(w2_s).view(np.int32))[None],
        torch.from_numpy(np.array(h_s))[None],
        torch.from_numpy(np.array(pos_s))[None],
        torch.tensor([hv], dtype=torch.int32), dense, gate, good, max_dist)
    return s[0].numpy(), c[0].numpy()


# every (dense, gate, good) case once, with both probe widths and all three
# window sizes spread over them (eager JAX compiles each shifted shape)
XLA_CASES = [c + (4, 32768) for c in CASES[:4]] + [
    CASES[4] + (4, 512), CASES[5] + (4, 4096),
    CASES[1] + (2, 512), CASES[3] + (2, 4096),
]


@pytest.mark.parametrize("dense,gate,good,W,max_dist", XLA_CASES)
def test_plain_matches_xla(dense, gate, good, W, max_dist):
    hv = 100
    for kind in ("text", "a8"):
        w2_s, h_s, pos_s = _jax_rows(_lane(kind), W)
        s_ref, c_ref = _xla(w2_s, h_s, pos_s, hv, dense=dense,
                            gate_depth=gate, good_l16=good, max_dist=max_dist)
        s, c = _port(w2_s, h_s, pos_s, hv, dense, gate, good, max_dist)
        np.testing.assert_array_equal(s, np.asarray(s_ref))
        np.testing.assert_array_equal(c, np.asarray(c_ref))


@pytest.mark.parametrize("dense,gate,good,W,max_dist", [
    (16, 16, 12, 4, 32768),
    (32, 16, 12, 2, 4096),
])
def test_plain_matches_pallas_interpret(dense, gate, good, W, max_dist):
    hv = 333
    w2_s, h_s, pos_s = _jax_rows(_lane("text"), W)
    s_ref, c_ref = probe_best_pallas(w2_s, h_s, pos_s, hv, dense, gate, good,
                                     max_dist=max_dist, interpret=True)
    s, c = _port(w2_s, h_s, pos_s, hv, dense, gate, good, max_dist)
    np.testing.assert_array_equal(s, np.asarray(s_ref))
    np.testing.assert_array_equal(c, np.asarray(c_ref))


def test_sorted_rows_match_reference_and_batch():
    """The port's (hash, pos) sort + gathered planes equal the reference's
    construction, and a 3-lane batch equals its lanes one by one."""
    lanes = np.stack([_lane("text"), _lane("a8"),
                      np.frombuffer(sample("runs", N, seed=5), np.uint8)])
    pad = torch.cat([torch.from_numpy(lanes),
                     torch.zeros((3, 16), dtype=torch.uint8)], 1)
    w2_s, h_s, pos_s, _ = tlz.sorted_probe_rows(tlz._build_w4(pad), N)
    hv = torch.tensor([0, 77, 1500], dtype=torch.int32)
    bs, bc = tprobe.probe_best(w2_s, h_s, pos_s, hv, 32, 16, 12, 4096)
    for i in range(3):
        rw, rh, rp = _jax_rows(lanes[i], 4)
        np.testing.assert_array_equal(w2_s[i].numpy(),
                                      np.asarray(rw).view(np.int32))
        np.testing.assert_array_equal(h_s[i].numpy(), np.asarray(rh))
        np.testing.assert_array_equal(pos_s[i].numpy(), np.asarray(rp))
        s_ref, c_ref = _xla(rw, rh, rp, int(hv[i]), dense=32, gate_depth=16,
                            good_l16=12, max_dist=4096)
        np.testing.assert_array_equal(bs[i].numpy(), np.asarray(s_ref))
        np.testing.assert_array_equal(bc[i].numpy(), np.asarray(c_ref))
