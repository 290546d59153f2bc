"""K2 (parse walk) of the PyTorch port against the JAX package.

The port's plain version (pointer doubling, the path a CPU tensor takes)
must equal the reference's `parse_select` (its CPU route, vmapped
`_reachable_jax`). The encode path's fused walk (`parse_select_encode`:
literal runs collapsed into single stops, then a cummax cover) must equal
plain `parse_select`: the reference on the CPU never runs the fused form,
so it is held against the unfused selection. Tolerance: none.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zlibng_tpu.ops.parse_pallas import parse_select as ref_parse_select
from zlibng_tpu_torch.ops import lz77 as tlz
from zlibng_tpu_torch.ops import parse as tparse

from torch_corpus import sample

N = 4096


def _steps(seed: int, B: int, match_rate: float) -> np.ndarray:
    """Random step arrays: literals (1) and matches (3..258)."""
    rng = np.random.default_rng(seed)
    is_m = rng.random((B, N)) < match_rate
    return np.where(is_m, rng.integers(3, 259, (B, N)), 1).astype(np.int32)


BOUNDS = np.array([[0, N], [100, 3000], [2048, 2049], [500, 500],
                   [N - 7, N]], np.int32)


@pytest.mark.parametrize("match_rate", [0.0, 0.05, 0.3, 0.9])
def test_plain_matches_reference(match_rate):
    step = _steps(int(match_rate * 100), BOUNDS.shape[0], match_rate)
    ref = np.asarray(ref_parse_select(jnp.asarray(step), jnp.asarray(BOUNDS)))
    got = tparse.parse_select(torch.from_numpy(step), torch.from_numpy(BOUNDS))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("match_rate", [0.0, 0.05, 0.3, 0.9])
def test_fused_encode_matches_unfused(match_rate):
    step = torch.from_numpy(_steps(7 + int(match_rate * 100),
                                   BOUNDS.shape[0], match_rate))
    bounds = torch.from_numpy(BOUNDS)
    plain = tparse.parse_select(step, bounds)
    fused = tparse.parse_select_encode(step, bounds)
    np.testing.assert_array_equal(fused.numpy(), plain.numpy())
    ref = np.asarray(ref_parse_select(jnp.asarray(step.numpy()),
                                      jnp.asarray(BOUNDS)))
    np.testing.assert_array_equal(fused.numpy(), ref)


def test_fused_encode_on_real_steps():
    """Step arrays from the port's stage 1 (lazy L6 rule) on real text."""
    lanes = torch.from_numpy(np.stack([
        np.frombuffer(sample(k, N, seed=2), np.uint8)
        for k in ("pigz", "text", "runs", "a4")]))
    B = lanes.shape[0]
    enc_end = torch.tensor([N, N - 100, 3000, N], dtype=torch.int32)
    core = tlz.lz77_lane(lanes, 1024, enc_end,
                         torch.zeros(B, dtype=torch.int32), 16, True, 32, 128,
                         unit=1024)
    bounds = torch.stack([torch.full((B,), 1024, dtype=torch.int32), enc_end],
                         1)
    fused = tparse.parse_select_encode(core["step"], bounds)
    ref = np.asarray(ref_parse_select(jnp.asarray(core["step"].numpy()),
                                      jnp.asarray(bounds.numpy())))
    np.testing.assert_array_equal(fused.numpy(), ref)
    # the fused walk makes one stop per match or literal-run start
    stops = tparse.parse_select(tparse.fused_steps(core["step"]), bounds)
    assert int(stops.sum()) < int(fused.sum())
