"""The port's sharded paths (`zlibng_tpu_torch/parallel/sharded.py`) on
k CPU shards against the JAX package's on a mesh of k virtual CPU devices
(tests/conftest.py makes 8): byte-identical streams for k in {1, 2, 4, 8}
and lane_block in {16384, 65536} (stored, dynamic and static lanes) and
at pigz's 131072 on four shards, exact adler32 partials and combines, the
static-tree step's arrays, and segment decode with equal outputs, error
text and `stats` moves (the reference propagates a stream error from the
mesh; the port copies that)."""
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from zlibng_tpu.errors import DataError as RefDataError
from zlibng_tpu.ops import inflate_tpu as ref_it
from zlibng_tpu.parallel import sharded as ref_sh
from zlibng_tpu_torch.errors import DataError
from zlibng_tpu_torch.ops import inflate as tit
from zlibng_tpu_torch.parallel import sharded as tsh
from zlibng_tpu_torch.stream import inflate_serial as tser

from torch_corpus import pigz_lanes, sample, synthetic, text


def _mesh(k: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:k]), ("d",))


def _mixed() -> bytes:
    """Text then random bytes: dynamic lanes, then a stored lane, at
    lane_block 16384 and 65536."""
    return text()[:60000] + synthetic("a256", 21920, seed=5)


def _block_types(z: bytes) -> list[int]:
    """BTYPE of every block of a zlib stream, in order."""
    inf = tser.RawInflater()
    inf.feed(z[2:-4])
    types = []
    while True:
        r = inf.run(finish=True, stop="trees")
        if r == tser.STREAM_END:
            return types
        if r == tser.TREES_DONE:
            types.append(0 if inf.state == tser._S_STORED else
                         1 if inf._lut_list is tser._FIXED_LUT_LIST else 2)


@pytest.fixture(scope="module")
def ref_streams():
    """The reference's stream of the mixed input per (k, lane_block), made
    once."""
    cache = {}

    def get(k, lane_block):
        if (k, lane_block) not in cache:
            cache[k, lane_block] = ref_sh.compress_multichip(
                _mixed(), _mesh(k), level=6, lane_block=lane_block)
        return cache[k, lane_block]
    return get


@pytest.mark.parametrize("lane_block", [16384, 65536])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_compress_multichip_matches_reference(ref_streams, k, lane_block):
    data = _mixed()
    got = tsh.compress_multichip(data, ["cpu"] * k, level=6,
                                 lane_block=lane_block)
    assert got == ref_streams(k, lane_block)
    assert zlib.decompress(got) == data
    assert struct.unpack(">I", got[-4:])[0] == zlib.adler32(data)
    assert _block_types(got) == ([2, 2, 2, 2, 0] if lane_block == 16384
                                 else [2, 0])


def test_compress_multichip_matches_reference_at_pigz_width():
    """pigz's -b 128 on four shards (one case: the reference compiles per
    shard count): dynamic, stored and static lanes of 128 KiB, each with
    the previous 32 KiB as history."""
    data = pigz_lanes()
    got = tsh.compress_multichip(data, ["cpu"] * 4, level=6,
                                 lane_block=131072)
    assert got == ref_sh.compress_multichip(data, _mesh(4), level=6,
                                            lane_block=131072)
    assert zlib.decompress(got) == data
    # the stored lane in three stored blocks of at most 65,535 bytes
    assert _block_types(got) == [2, 2, 2, 2, 0, 0, 0, 1]


@pytest.mark.parametrize("k", [1, 8])
def test_static_lane_matches_reference(k):
    """300 B of text: one lane, where the static tree wins."""
    data = text()[5000:5300]
    got = tsh.compress_multichip(data, ["cpu"] * k, lane_block=16384)
    assert got == ref_sh.compress_multichip(data, _mesh(k),
                                            lane_block=16384)
    assert zlib.decompress(got) == data
    assert _block_types(got) == [1]


def test_shard_count_decides_the_bytes_not_the_devices():
    """[cpu] * k shards in one process, for k = 1 and 3: the bytes follow
    the shard count (as a mesh's size decides them), and both decode."""
    data = sample("pigz", 50000)
    one = tsh.compress_multichip(data, ["cpu"], lane_block=16384)
    three = tsh.compress_multichip(data, ["cpu"] * 3, lane_block=16384)
    assert zlib.decompress(one) == zlib.decompress(three) == data


def test_lane_adler_and_combines_are_exact():
    rng = np.random.default_rng(11)
    B, N = 6, 5000
    lanes = rng.integers(0, 256, (B, N), dtype=np.uint8)
    lanes[1] = 255                                 # the largest products
    es = np.array([0, 0, 100, 4999, 2048, 7], np.int32)
    ee = np.array([5000, 5000, 4096, 5000, 2048, 4100], np.int32)
    got = tsh._lane_adler(torch.from_numpy(lanes), torch.from_numpy(es),
                          torch.from_numpy(ee)).numpy()
    ref = np.asarray(jax.vmap(ref_sh._lane_adler)(
        jnp.asarray(lanes), jnp.asarray(es), jnp.asarray(ee)))
    assert got.tolist() == ref.astype(np.int64).tolist()
    assert got.tolist() == [zlib.adler32(lanes[i, es[i]:ee[i]].tobytes())
                            for i in range(B)]
    # pairwise combine and the host merge of shard values
    a, b = torch.from_numpy(got[:3]), torch.from_numpy(got[3:])
    lens = torch.from_numpy((ee - es)[3:].astype(np.int64))
    pair = tsh._adler_combine_pair(a, b, lens).numpy()
    ref_pair = np.asarray(ref_sh._adler_combine_pair(
        jnp.asarray(got[:3].astype(np.uint32)),
        jnp.asarray(got[3:].astype(np.uint32)),
        jnp.asarray((ee - es)[3:].astype(np.uint32))))
    assert pair.tolist() == ref_pair.astype(np.int64).tolist()
    lens_all = (ee - es).tolist()
    assert tsh.combine_shard_adlers(got, lens_all) \
        == ref_sh.combine_shard_adlers(got.astype(np.uint32), lens_all) \
        == zlib.adler32(b"".join(lanes[i, es[i]:ee[i]].tobytes()
                                 for i in range(B)))
    x = torch.from_numpy(rng.integers(0, 65521, (3, 37)))
    assert tsh._mod_tree(x, 65521).tolist() == [
        int(v) % 65521 for v in x.sum(1)]


def test_compress_step_matches_reference_dry_run():
    """The reference's static-tree step as __graft_entry__.py drives it
    (8 shards, 16 lanes of 2048 B, chain 2): every array equal."""
    n, LANE, OUT = 8, 2048, 2048
    B = 2 * n
    rng = np.random.default_rng(1)
    lanes = rng.integers(0, 16, (B, LANE), dtype=np.uint8)
    es = np.zeros(B, np.int32)
    ee = np.full(B, LANE, np.int32)
    hv = np.zeros(B, np.int32)
    ref = ref_sh.make_compress_step(_mesh(n), LANE, OUT, chain=2, lazy=True,
                                    max_lazy=16)(
        jnp.asarray(lanes), jnp.asarray(es), jnp.asarray(ee),
        jnp.asarray(hv))
    shards = tsh.Shards(["cpu"] * n)
    step = tsh.make_compress_step(shards, LANE, OUT, chain=2, lazy=True,
                                  max_lazy=16)
    packed, totals, all_bits, adlers = step(lanes, es, ee, hv)
    assert np.array_equal(shards.gather(packed), np.asarray(ref[0]))
    assert np.array_equal(shards.gather(totals), np.asarray(ref[1]))
    assert np.array_equal(all_bits, np.asarray(ref[2]))
    assert adlers.tolist() == np.asarray(ref[3]).astype(np.int64).tolist()
    with pytest.raises(ValueError, match="enc_start"):
        step(lanes, np.arange(B, dtype=np.int32), ee, hv)


def test_lane_freqs_match_reference():
    from zlibng_tpu.ops import lz77_jax
    from zlibng_tpu_torch.ops import lz77
    rng = np.random.default_rng(2)
    B, N = 3, 3000
    lsym = rng.integers(0, 286, (B, N)).astype(np.int32)
    dsym = rng.integers(0, 30, (B, N)).astype(np.int32)
    sel = rng.random((B, N)) < 0.6
    im = rng.random((B, N)) < 0.3
    lf, df = lz77.lane_freqs(*(torch.from_numpy(x) for x in (lsym, dsym, sel,
                                                             im)))
    for b in range(B):
        rl, rd = lz77_jax.lane_freqs(jnp.asarray(lsym[b]), jnp.asarray(
            dsym[b]), jnp.asarray(sel[b]), jnp.asarray(im[b]))
        assert lf[b].tolist() == np.asarray(rl).tolist()
        assert df[b].tolist() == np.asarray(rd).tolist()


def test_block_estimate_matches_reference():
    """ops/deflate.py's _est_block_bits_batch over _extra_bits_batch equals
    the reference's float64 estimate bit for bit (empty rows included)."""
    from zlibng_tpu.ops import deflate_tpu
    from zlibng_tpu_torch.ops import deflate
    rng = np.random.default_rng(4)
    lf = rng.integers(0, 5000, (6, 286)) * (rng.random((6, 286)) < 0.5)
    df = rng.integers(0, 900, (6, 30)) * (rng.random((6, 30)) < 0.5)
    lf[0], df[0] = 0, 0
    got = deflate._est_block_bits_batch(lf, df,
                                        deflate._extra_bits_batch(lf, df))
    want = deflate_tpu._est_block_bits_batch(lf, df)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()


def _segments():
    data = sample("pigz", 60000) + sample("text", 30000)
    blob, idx = chip_smoke.indexed_blob(data, 16384)
    return data, blob, idx.comp_offsets[:-1]


def _outcome(fn, stats, err):
    before = dict(stats)
    try:
        got = [bytes(o) for o in fn()]
    except err as e:
        got = f"error: {e}"
    return got, {k: stats[k] - before[k] for k in before}


@pytest.mark.parametrize("k", [2, 8])
def test_segment_decode_matches_reference(k):
    data, blob, starts = _segments()
    port = _outcome(lambda: tsh.decompress_segments_multichip(
        blob, starts, ["cpu"] * k), tit.stats, DataError)
    ref = _outcome(lambda: ref_sh.decompress_segments_multichip(
        blob, starts, _mesh(k)), ref_it.stats, RefDataError)
    assert port == ref
    assert b"".join(port[0]) == data
    assert port[1]["mesh_ok"] == 1 and port[1]["fallback"] == 0


@pytest.mark.parametrize("where", ["header", "body"])
def test_corrupt_segment_matches_reference(where):
    """A bad dynamic header raises InflateError from the sharded decode
    (stats["error"]); bad Huffman data makes phase A give the stream up
    (stats["fallback"]) to the single-device engine, whose serial rerun
    raises zlib's text."""
    _, blob, starts = _segments()
    c = bytearray(blob)
    pos = starts[1] + (2 if where == "header" else 397)
    c[pos] ^= 0x55
    port = _outcome(lambda: tsh.decompress_segments_multichip(
        bytes(c), starts, ["cpu"] * 2), tit.stats, DataError)
    ref = _outcome(lambda: ref_sh.decompress_segments_multichip(
        bytes(c), starts, _mesh(2)), ref_it.stats, RefDataError)
    assert port == ref
    assert isinstance(port[0], str) and port[0].startswith("error: ")
    moved = "error" if where == "header" else "fallback"
    assert port[1][moved] >= 1 and port[1]["mesh_ok"] == 0


def test_no_devices_and_uncarded_cuda_raise(monkeypatch):
    with pytest.raises(ValueError):
        tsh.Shards([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsh.compress_multichip(b"x" * 5000)
    with pytest.raises(RuntimeError, match="cuda"):
        tsh.decompress_segments_multichip(b"\x03\x00", [0])


def test_chip_smoke_corrupt_blob_raises_the_reference_text():
    """chip_smoke.py's sharded decode pins the reference's error for its
    corrupt indexed blob (SHARDED_CORRUPT); recompute it here."""
    data, _ = chip_smoke.corpus()
    blob, idx = chip_smoke.indexed_blob(data)
    starts = idx.comp_offsets[:-1]
    seg, at, text = chip_smoke.SHARDED_CORRUPT
    c = bytearray(blob)
    c[starts[seg] + at] ^= 0x55
    port = _outcome(lambda: tsh.decompress_segments_multichip(
        bytes(c), starts, ["cpu"] * 2), tit.stats, DataError)
    ref = _outcome(lambda: ref_sh.decompress_segments_multichip(
        bytes(c), starts, _mesh(2)), ref_it.stats, RefDataError)
    assert port == ref
    assert port[0] == f"error: {text}" and port[1]["error"] == 1


def test_render_matches_reference():
    """ops/bitpack.py's one render, render_tokens (batched, without
    demotion, as the sharded steps call it), against the reference's
    per-lane render_body_tokens, on random tokens and per-lane tables
    (lengths 0-15, codes below 2^length); the port's render_body_tokens
    gives the same arrays."""
    from zlibng_tpu.ops import bitpack_jax
    from zlibng_tpu.ops.lz77_jax import dist_code_arith, length_code_arith
    from zlibng_tpu_torch.ops import bitpack
    rng = np.random.default_rng(13)
    B, N = 3, 2000
    tl = np.where(rng.random((B, N)) < 0.3, rng.integers(3, 259, (B, N)), 0)
    td = np.where(tl > 0, rng.integers(1, 32769, (B, N)), 0)
    sel = rng.random((B, N)) < 0.7
    lit = rng.integers(0, 256, (B, N))
    ls = np.where(tl > 0, np.asarray(length_code_arith(jnp.asarray(
        np.maximum(tl, 3).astype(np.int32)))), lit).astype(np.int32)
    ds = np.where(tl > 0, np.asarray(dist_code_arith(jnp.asarray(
        np.maximum(td, 1).astype(np.int32)))), 0).astype(np.int32)
    tl, td = tl.astype(np.int32), td.astype(np.int32)
    ll = rng.integers(0, 16, (B, 288)).astype(np.int32)
    lc = (rng.integers(0, 1 << 15, (B, 288)) % (1 << ll)).astype(np.int32)
    dl = rng.integers(0, 16, (B, 30)).astype(np.int32)
    dc = (rng.integers(0, 1 << 15, (B, 30)) % (1 << dl)).astype(np.int32)
    lo, hi, nb = bitpack.render_tokens(*(torch.from_numpy(x) for x in (
        lit, tl, td, sel, ll, lc, dl, dc)))
    body = bitpack.render_body_tokens(*(torch.from_numpy(x) for x in (
        tl, td, ls, ds, sel, ll, lc, dl, dc)))
    assert all(torch.equal(a, b) for a, b in zip(body, (lo, hi, nb)))
    for b in range(B):
        rlo, rhi, rnb = bitpack_jax.render_body_tokens(*(
            jnp.asarray(x[b]) for x in (tl, td, ls, ds, sel, ll, lc, dl,
                                        dc)))
        assert lo[b].tolist() == np.asarray(rlo).astype(np.int64).tolist()
        assert hi[b].tolist() == np.asarray(rhi).astype(np.int64).tolist()
        assert nb[b].tolist() == np.asarray(rnb).tolist()
