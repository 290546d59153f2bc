"""Stage 1 and stage 2 of the PyTorch port against the JAX package.

`_stage1` over a lane group (with a padded lane that reads clamped tail
bytes, as the reference's dynamic slices do) must give equal token arrays
and per-unit (q, 286)/(q, 30) frequencies. `_stage2_auto` must give equal
(body, hdr, meta) for equal stage-1 inputs, in a bucket that fits and in
one that overflows (the case the caller redoes). The one render
(`ops/bitpack.py:render_tokens`) with per-unit dynamic tables and
demotion, then the pack, must give the reference's `_render_pack_unit`
bytes. Tolerance: none.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zlibng_tpu.ops import deflate_tpu as ref
from zlibng_tpu.ops.bitpack_merge import hierarchical_pack as ref_pack
from zlibng_tpu.stream.deflate import LEVELS as REF_LEVELS
from zlibng_tpu_torch.ops import deflate as tdef
from zlibng_tpu_torch.ops.bitpack import _or_field, render_tokens
from zlibng_tpu_torch.ops.bitpack_merge import hierarchical_pack
from zlibng_tpu_torch.ops.huffman import huff_build

from torch_corpus import sample

H = ref.LANE_HIST
UNIT = ref.UNIT


def _group(lane_block: int, parts, tail: int):
    """flat buffer (history + len(parts) lanes), enc_ends padded to the
    pow2 lane count, and hist_valids with a dictionary-like first bound."""
    payload = b"".join(parts)[: len(parts) * lane_block - tail]
    B = len(parts)
    Bpad = 1 << (B - 1).bit_length()
    flat = np.zeros(H + B * lane_block, np.uint8)
    flat[H - 5000: H] = np.frombuffer(sample("text", 5000, seed=1), np.uint8)
    flat[H: H + len(payload)] = np.frombuffer(payload, np.uint8)
    enc_ends = np.full(Bpad, H, np.int32)
    for i in range(B):
        enc_ends[i] = H + min(lane_block, len(payload) - i * lane_block)
    hist = np.zeros(Bpad, np.int32)
    hist[0] = H - 5000
    return flat, enc_ends, hist


@pytest.fixture(scope="module")
def stage1_pair():
    lane_block = 32768
    lc = REF_LEVELS[6]
    parts = [sample("pigz", lane_block), sample("runs", lane_block, seed=2),
             sample("text", lane_block)]
    flat, enc_ends, hist = _group(lane_block, parts, tail=9000)
    r_tok, r_lf, r_df = ref._stage1(
        jnp.asarray(flat), jnp.asarray(enc_ends), jnp.asarray(hist),
        lane_block, lc.chain, lc.lazy, lc.max_lazy, lc.nice, 0, lc.good)
    t_tok, t_lf, t_df = tdef._stage1(
        torch.from_numpy(flat), torch.from_numpy(enc_ends),
        torch.from_numpy(hist), lane_block, lc.chain, lc.lazy, lc.max_lazy,
        lc.nice, 0, lc.good)
    return (r_tok, r_lf, r_df), (t_tok, t_lf, t_df)


def test_stage1_matches_reference(stage1_pair):
    (r_tok, r_lf, r_df), (t_tok, t_lf, t_df) = stage1_pair
    assert t_tok["sel"].shape == (4, H + 32768)       # padded lane included
    for k in ("sel", "tok_len", "tok_dist"):
        np.testing.assert_array_equal(t_tok[k].numpy(),
                                      np.asarray(r_tok[k]).astype(
                                          t_tok[k].numpy().dtype), err_msg=k)
    np.testing.assert_array_equal(t_lf.numpy(), np.asarray(r_lf))
    np.testing.assert_array_equal(t_df.numpy(), np.asarray(r_df))
    assert int(t_lf.sum()) > 0 and int(t_df.sum()) > 0


@pytest.mark.parametrize("out_bytes", [12288, 4096])
def test_stage2_auto_matches_reference(out_bytes):
    """text | random | text | runs units in one lane, a partial second
    lane: stored, static and dynamic blocks and a split partition."""
    lane_block = 65536
    lc = REF_LEVELS[6]
    rnd = sample("a256", UNIT, seed=8)
    lane0 = (sample("text", UNIT) + rnd + sample("pigz", UNIT)
             + sample("runs", UNIT, seed=3))
    flat, enc_ends, hist = _group(
        lane_block, [lane0, sample("cve", lane_block)], tail=20000)
    tok, lf, df = ref._stage1(
        jnp.asarray(flat), jnp.asarray(enc_ends), jnp.asarray(hist),
        lane_block, lc.chain, lc.lazy, lc.max_lazy, lc.nice, 0, lc.good)
    want = ref._stage2_auto(jnp.asarray(flat), tok["tok_len"], tok["tok_dist"],
                            tok["sel"], lf, df, jnp.asarray(enc_ends),
                            lane_block, out_bytes)
    got = tdef._stage2_auto(
        torch.from_numpy(flat),
        torch.from_numpy(np.asarray(tok["tok_len"]).astype(np.int32)),
        torch.from_numpy(np.asarray(tok["tok_dist"]).astype(np.int32)),
        torch.from_numpy(np.array(tok["sel"])),
        torch.from_numpy(np.asarray(lf).astype(np.int32)),
        torch.from_numpy(np.asarray(df).astype(np.int32)),
        torch.from_numpy(enc_ends), lane_block, out_bytes)
    for name, g, w in zip(("body", "hdr", "meta"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    meta = np.asarray(want[2])
    assert {0, 2} <= set((meta[:, :, 2] & 3).ravel().tolist())
    # the small bucket really overflows (and clamps) in some coded unit
    coded = (meta[:, :, 2] & 3) != 0
    over = meta[:, :, 0][coded].max() > (out_bytes - 8) * 8
    assert over == (out_bytes == 4096)


@pytest.mark.parametrize("corpus", ["pigz", "cve"])
def test_render_dynamic_demoted_matches_reference(corpus):
    """One 64 KiB lane of L6 stage-1 tokens (tar and text: both have
    matches that their unit's own tables make dearer than literals), each
    16 KiB unit rendered against its own dynamic tables (the Huffman build
    of its counts plus an EOB) with demotion, then packed, against the
    reference's per-unit `_render_pack_unit`."""
    lane_block, out_bytes = 4 * UNIT, 12288
    lc = REF_LEVELS[6]
    flat, enc_ends, hist = _group(lane_block, [sample(corpus, lane_block,
                                                      seed=4)], tail=0)
    tok, lf, df = tdef._stage1(
        torch.from_numpy(flat), torch.from_numpy(enc_ends),
        torch.from_numpy(hist), lane_block, lc.chain, lc.lazy, lc.max_lazy,
        lc.nice, 0, lc.good)
    lf = lf.reshape(4, 286).clone()
    lf[:, 256] += 1
    llen, lcode, dlen, dcode = huff_build(lf, df.reshape(4, 30), 4)[:4]
    z2 = torch.zeros((4, 2), dtype=torch.int32)
    tables = (torch.cat([llen, z2], 1), torch.cat([lcode, z2], 1), dlen,
              dcode)
    units = [torch.from_numpy(flat[H:].reshape(4, UNIT).copy())] + [
        tok[k][:, H:].reshape(4, UNIT) for k in ("tok_len", "tok_dist", "sel")]
    fields = render_tokens(*units, *tables, demote=True)
    packed, bits = hierarchical_pack(*fields, out_bytes)
    rpacked, rbits = jax.jit(jax.vmap(
        lambda *a: ref._render_pack_unit(*a, out_bytes)))(
        *(jnp.asarray(t.numpy()) for t in (*units, *tables)))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rbits))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(rpacked))
    # some match was demoted: the render differs from the undemoted one
    plain = render_tokens(*units, *tables)[2]
    assert (plain != fields[2]).any()


def test_hierarchical_pack_matches_reference():
    rng = np.random.default_rng(5)
    R, T = 3, 700
    nb = rng.integers(0, 56, (R, T)).astype(np.int32)
    nb[1, ::3] = 0
    lo = rng.integers(0, 1 << 32, (R, T), dtype=np.uint64)
    hi = rng.integers(0, 1 << 32, (R, T), dtype=np.uint64)
    out_bytes = int(nb.sum(1).max()) // 8 + 16
    got, gbits = hierarchical_pack(torch.from_numpy(lo.astype(np.int64)),
                                   torch.from_numpy(hi.astype(np.int64)),
                                   torch.from_numpy(nb), out_bytes)
    fn = jax.jit(jax.vmap(lambda a, b, c: ref_pack(a, b, c, out_bytes)))
    want, wbits = fn(jnp.asarray(lo.astype(np.uint32)),
                     jnp.asarray(hi.astype(np.uint32)), jnp.asarray(nb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gbits.numpy(), np.asarray(wbits))


def test_or_field_matches_reference():
    from zlibng_tpu.ops.bitpack_jax import _or_field as ref_or
    rng = np.random.default_rng(6)
    lo = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    hi = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    val = rng.integers(0, 1 << 15, 4096, dtype=np.uint64)
    sh = rng.integers(0, 56, 4096).astype(np.int32)
    glo, ghi = _or_field(torch.from_numpy(lo.astype(np.int64)),
                         torch.from_numpy(hi.astype(np.int64)),
                         torch.from_numpy(val.astype(np.int64)),
                         torch.from_numpy(sh))
    wlo, whi = ref_or(jnp.asarray(lo.astype(np.uint32)),
                      jnp.asarray(hi.astype(np.uint32)),
                      jnp.asarray(val.astype(np.uint32)), jnp.asarray(sh))
    np.testing.assert_array_equal(glo.numpy(), np.asarray(wlo))
    np.testing.assert_array_equal(ghi.numpy(), np.asarray(whi))
