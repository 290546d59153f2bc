"""The port's indexed and segment decode (`parallel/index.py`,
`ops/inflate.py:decompress_segments_cuda`, device="cpu") against the JAX
package's on blobs from its `compress_indexed` and from stdlib zlib's
Z_FULL_FLUSH; the index scan and StreamIndex JSON too. Outputs, error
strings and `stats` deltas equal. The port's own `compress_indexed` (the
host Deflate with a full flush per segment) writes the reference's blob
and index, which decode on the port's device path."""
import functools

import pytest

import chip_smoke
import zlibng_tpu.stream.inflate_serial as ref_ser
from zlibng_tpu.errors import DataError as RefDataError
from zlibng_tpu.ops import inflate_tpu as itpu
from zlibng_tpu.parallel import index as ref_index
from zlibng_tpu_torch.errors import DataError
from zlibng_tpu_torch.ops import inflate as ti
from zlibng_tpu_torch.parallel import index as tindex

from torch_corpus import pigz, sample


@pytest.fixture(autouse=True)
def ref_numpy_path(monkeypatch):
    monkeypatch.setattr(ref_ser, "_native_lib", False)


def _data() -> bytes:
    return pigz()[:60000] + sample("a16", 6000) + bytes(20000) + \
        sample("runs", 20000)


@functools.lru_cache(maxsize=None)
def _blob(kind: str):
    """(blob, reference StreamIndex, data)."""
    data = _data()
    if kind == "compress_indexed":
        blob, idx = ref_index.compress_indexed(data, level=6,
                                               segment=1 << 15)
        return blob, idx, data
    blob, idx = chip_smoke.indexed_blob(data, 25000)
    return blob, ref_index.StreamIndex.from_json(idx.to_json()), data


def _port_index(idx) -> tindex.StreamIndex:
    return tindex.StreamIndex.from_json(idx.to_json())


def _delta(stats, fn):
    before = dict(stats)
    try:
        out = fn()
    except (DataError, RefDataError) as e:
        out = f"error: {e}"
    return out, {k: stats[k] - before[k] for k in before}


KINDS = ["compress_indexed", "zlib full flush"]


@pytest.mark.parametrize("kind", KINDS)
def test_segments_match_reference(kind):
    blob, idx, data = _blob(kind)
    starts = idx.comp_offsets[:-1]
    assert len(starts) >= 3
    got = _delta(ti.stats, lambda: ti.decompress_segments_cuda(
        blob, starts, device="cpu"))
    want = _delta(itpu.stats, lambda: itpu.decompress_segments_tpu(
        blob, starts))
    assert got == want
    assert b"".join(got[0]) == data and got[1]["device_ok"] == 1


@pytest.mark.parametrize("kind", KINDS)
def test_indexed_matches_reference(kind):
    blob, idx, data = _blob(kind)
    pidx = _port_index(idx)
    got = _delta(ti.stats, lambda: tindex.decompress_indexed_cuda(
        blob, pidx, device="cpu"))
    want = _delta(itpu.stats, lambda: ref_index.decompress_indexed_tpu(
        blob, idx))
    assert got == want and got[0] == data
    assert tindex.decompress_indexed(blob, pidx) == \
        ref_index.decompress_indexed(blob, idx) == data


@pytest.mark.parametrize("kind", KINDS)
def test_index_scan_matches_reference(kind):
    blob, idx, _ = _blob(kind)
    assert tindex.find_sync_candidates(blob) == \
        ref_index.find_sync_candidates(blob)
    assert tindex.find_sync_candidates(blob, 1000) == \
        ref_index.find_sync_candidates(blob, 1000)
    got = tindex.build_index_by_scan(blob)
    assert got.to_json() == ref_index.build_index_by_scan(blob).to_json()
    # every true boundary is found (the scan may add false positives)
    assert set(idx.comp_offsets) <= set(got.comp_offsets)


def test_stream_index_json_matches_reference():
    _, idx, _ = _blob("compress_indexed")
    pidx = _port_index(idx)
    assert pidx.to_json() == idx.to_json()
    assert (pidx.comp_offsets, pidx.out_offsets, pidx.total_out) == \
        (idx.comp_offsets, idx.out_offsets, idx.total_out)
    assert tindex.SYNC_MARKER == ref_index.SYNC_MARKER


def test_corrupt_segment_falls_back_like_reference():
    blob, idx, _ = _blob("zlib full flush")
    c = bytearray(blob)
    c[idx.comp_offsets[1] + 40] ^= 0xFF
    c = bytes(c)
    starts = idx.comp_offsets[:-1]
    got = _delta(ti.stats, lambda: ti.decompress_segments_cuda(
        c, starts, device="cpu"))
    want = _delta(itpu.stats, lambda: itpu.decompress_segments_tpu(
        c, starts))
    assert got == want and got[1]["fallback"] == 1


def test_index_mismatch_error_matches_reference():
    blob, idx, _ = _blob("compress_indexed")
    bad = ref_index.StreamIndex(list(idx.comp_offsets),
                                list(idx.out_offsets), idx.total_out + 7)
    bad.out_offsets[-1] += 7
    pbad = _port_index(bad)
    got = _delta(ti.stats, lambda: tindex.decompress_indexed_cuda(
        blob, pbad, device="cpu"))
    want = _delta(itpu.stats, lambda: ref_index.decompress_indexed_tpu(
        blob, bad))
    assert got == want and got[0] == "error: index/stream mismatch"


@pytest.mark.parametrize("segment", [1 << 14, 1 << 12])
def test_compress_indexed_matches_reference(segment):
    data = _data()[:36000] + bytes(8000) + sample("runs", 12000)
    blob, idx = tindex.compress_indexed(data, level=6, segment=segment)
    ref_blob, ref_idx = ref_index.compress_indexed(data, level=6,
                                                   segment=segment)
    assert blob == ref_blob and idx.to_json() == ref_idx.to_json()
    assert len(blob) < 16384 and len(idx.comp_offsets) >= 5
    got = _delta(ti.stats, lambda: tindex.decompress_indexed_cuda(
        blob, idx, device="cpu"))
    assert got[0] == data and got[1]["device_ok"] == 1
    assert tindex.decompress_indexed(blob, idx) == data


@pytest.mark.parametrize("data", [b"", b"x", bytes(1000)],
                         ids=["empty", "one byte", "1000 zeros"])
def test_compress_indexed_edges_match_reference(data):
    blob, idx = tindex.compress_indexed(data, level=1, segment=256)
    ref_blob, ref_idx = ref_index.compress_indexed(data, level=1,
                                                   segment=256)
    assert blob == ref_blob and idx.to_json() == ref_idx.to_json()
    assert tindex.decompress_indexed(blob, idx) == data
