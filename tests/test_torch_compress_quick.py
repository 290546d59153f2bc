"""The fixed-tree quick path of the PyTorch port (L1 with the default
strategy, Z_FIXED at any level) against the JAX package.

compress_cuda(device="cpu") must give compress_tpu's bytes, which stdlib
zlib decodes, on text, tar, random bytes (stored units) and runs; the
one render (`ops/bitpack.py:render_tokens`) against the static code tables,
then the pack, is held to the reference's fixed render + pack with
demotion on and off. Its framing, dictionary,
lane-group and routing cases are in test_torch_compress_quick_args.py.
Tolerance: none.
"""
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zlibng_tpu.ops import deflate_tpu as ref
from zlibng_tpu.ops.deflate_tpu import compress_tpu
from zlibng_tpu_torch import compress_cuda
from zlibng_tpu_torch.ops import deflate as tdef
from zlibng_tpu_torch.ops.bitpack import code_tables, render_tokens
from zlibng_tpu_torch.ops.bitpack_merge import hierarchical_pack

from torch_corpus import sample

N = 40000


def _same(data, **kw):
    want = compress_tpu(data, **kw)
    got = compress_cuda(data, device="cpu", **kw)
    assert got == want
    return got


@pytest.mark.parametrize("corpus", ["pigz", "text", "a256", "runs"])
def test_l1_byte_identical(corpus):
    data = sample(corpus, N, seed=1)
    assert zlib.decompress(_same(data, level=1)) == data


@pytest.mark.parametrize("level", [1, 3, 6, 9])
@pytest.mark.parametrize("corpus", ["pigz", "a256"])
def test_z_fixed_byte_identical(level, corpus):
    data = sample(corpus, N, seed=level)
    assert zlib.decompress(_same(data, level=level, strategy=4)) == data


@pytest.mark.parametrize("demote", [False, True])
def test_render_pack_unit_fixed_matches_reference(demote):
    """Four units of text + runs tokens (stage 1 of the port): the one
    render against the static code tables, then the pack into the
    12288-byte bucket, against the reference's closed-form fixed render."""
    lb = 1 << 16
    payload = np.frombuffer(sample("text", 3 * tdef.UNIT)
                            + sample("runs", tdef.UNIT, seed=2), np.uint8)
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(tdef.LANE_HIST, np.uint8), payload]))
    enc = torch.tensor([tdef.LANE_HIST + lb], dtype=torch.int32)
    hv = torch.tensor([tdef.LANE_HIST], dtype=torch.int32)
    toks, fb, _ = tdef._stage1(flat, enc, hv, lb, 2, False, 4, 16, 0, 8,
                               quick=True)
    units = [t[:, tdef.LANE_HIST:].reshape(4, tdef.UNIT)
             for t in (toks["tok_len"], toks["tok_dist"], toks["sel"])]
    qbytes = torch.from_numpy(payload.reshape(4, tdef.UNIT).copy())
    C = code_tables("cpu")
    packed, bits = hierarchical_pack(*render_tokens(
        qbytes, *units, C["fl288"], C["flc"], C["fdl"], C["fdc"],
        demote=demote), 12288)
    rpacked, rbits = jax.jit(jax.vmap(
        lambda q, a, b, c: ref._render_pack_unit_fixed(q, a, b, c, 12288,
                                                       demote)))(
        *(jnp.asarray(t.numpy()) for t in (qbytes, *units)))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rbits))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(rpacked))
    # the stage-1 static bit count is exact without demotion
    if not demote:
        np.testing.assert_array_equal(fb[0].numpy(), bits.numpy())
