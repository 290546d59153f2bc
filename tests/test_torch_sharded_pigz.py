"""pigz's layout (`pigz -6 -z -b 128 -p 4`) through the port's sharded
compress, `compress_multichip(data, ["cpu"] * 4, level=6,
lane_block=131072)`, against the plain reference `tests/pigz_plain.py`
(stdlib zlib, each 128 KiB block primed with the 32 KiB before it), and
the trace root the call opens (`ops/deflate.py:stage_seconds`). This file
imports nothing of JAX."""
import zlib

import numpy as np
import pytest

import pigz_plain
from zlibng_tpu_torch import compress_cuda, compress_multichip
from zlibng_tpu_torch.ops import deflate

from torch_corpus import pigz_lanes, text

LANE = 131072
# The port's stream against the plain reference's, in %: the port puts
# each 128 KiB lane in one block with its tree built from the lane's
# histogram (zlib splits a block where its symbol buffer fills) and saves
# pigz's sync markers; on pigz_lanes() it reads 1.29% over.
MARGIN_PCT = 3.0
SHARDED_SPANS = ("frame", "sharded.stage1", "sharded.stage1.shard",
                 "sharded.trees", "sharded.stage2", "sharded.stage2.shard",
                 "stitch")
LANE_KINDS = ("sharded.lanes_stored", "sharded.lanes_static",
              "sharded.lanes_dynamic")


def _port(data: bytes) -> bytes:
    return compress_multichip(data, ["cpu"] * 4, level=6, lane_block=LANE)


@pytest.fixture(scope="module")
def port_call():
    """One call on pigz_lanes(): its stream, the records of every root
    that closed during it, and the view it left."""
    data = pigz_lanes()
    seen = []
    publish = deflate._publish

    def keep(call):
        seen.append(call)
        publish(call)

    deflate._publish = keep
    try:
        out = _port(data)
    finally:
        deflate._publish = publish
    return data, out, seen, dict(deflate.stage_seconds)


def test_port_and_plain_reference_decode_to_the_input(port_call):
    data, out, _, _ = port_call
    ref = pigz_plain.compress(data)
    assert zlib.decompress(out) == data
    assert zlib.decompress(ref) == data
    assert out[-4:] == ref[-4:] == zlib.adler32(data).to_bytes(4, "big")


def test_port_size_within_margin_of_the_plain_reference(port_call):
    data, out, _, _ = port_call
    ref = len(pigz_plain.compress(data))
    assert 100.0 * (len(out) / ref - 1.0) <= MARGIN_PCT


def test_every_block_is_primed_with_the_previous_32k():
    """Each block after the first opens with a copy of the last 31 KiB of
    the one before, then uniform bytes: only a stream that primes a block
    with its predecessor's tail finds the copy. (31 KiB, not 32: zlib
    reaches back at most 32,768 - 262 bytes.)"""
    rng = np.random.default_rng(3)
    back = 31 << 10
    blocks = [rng.integers(0, 256, LANE, dtype=np.uint8).tobytes()]
    for _ in range(4):
        fresh = rng.integers(0, 256, LANE - back, dtype=np.uint8).tobytes()
        blocks.append(blocks[-1][-back:] + fresh)
    data = b"".join(blocks)
    out, ref = _port(data), pigz_plain.compress(data)
    assert zlib.decompress(out) == zlib.decompress(ref) == data
    # four of five blocks a quarter redundant: about 0.81 of the input
    assert len(out) < 0.83 * len(data) and len(ref) < 0.83 * len(data)
    # without history no block finds its copy
    alone = sum(len(zlib.compress(b, 6)) for b in blocks)
    assert alone > len(data)


def test_plain_reference_lays_out_pigz_blocks():
    """pigz.c's header at -6 (level clue 1: 78 5e), a sync marker after
    every block but the last, and the empty input."""
    data = text()[:3 * LANE // 2]
    out = pigz_plain.compress(data, level=6, block=LANE // 2)
    assert out[:2] == bytes.fromhex("785e")
    assert out.count(b"\x00\x00\xff\xff") >= 2
    assert zlib.decompress(out) == data
    assert zlib.decompress(pigz_plain.compress(b"")) == b""
    for level in (1, 6, 9):
        assert int.from_bytes(pigz_plain.zlib_header(level), "big") % 31 == 0


def test_one_call_opens_one_root(port_call):
    _, _, seen, _ = port_call
    (call,) = seen
    assert call.spans[0].name == "compress_multichip"
    assert call.spans[0].parent is None
    assert all(sp.parent is not None for sp in call.spans[1:])


def test_view_holds_the_sharded_spans_and_waits(port_call):
    _, _, seen, view = port_call
    for name in SHARDED_SPANS + ("syncs.n", "compress_multichip"):
        assert view[name] > 0, name
    for name in ("sharded.stage1.shard", "sharded.stage2.shard"):
        spans = [sp for sp in seen[0].spans if sp.name == name]
        assert [sp.ids["shard"] for sp in spans] == [0, 1, 2, 3]
        assert all(sp.parent.name == name.rsplit(".", 1)[0] for sp in spans)
    # the gathers are waits, timed under their step
    assert view["sharded.stage1.fetch"] > 0 and view["stitch.fetch"] > 0


def test_lane_counters_sum_to_the_lanes(port_call):
    data, _, _, view = port_call
    assert view["sharded.shards.n"] == 4
    assert view["sharded.lanes.n"] == -(-len(data) // LANE) == 6
    assert sum(view[k + ".n"] for k in LANE_KINDS) == 6
    assert [view[k + ".n"] for k in LANE_KINDS] == [1, 1, 4]


def test_compress_cuda_after_it_keeps_its_own_keys(port_call):
    data = text()[:40000]
    assert zlib.decompress(compress_cuda(data, 6, device="cpu")) == data
    view = deflate.stage_seconds
    assert view["stage1"] > 0 and view["stage2"] > 0 and "frame" in view
    assert not any(k.startswith("sharded.") for k in view)
    assert "compress_multichip" not in view
