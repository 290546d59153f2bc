"""The port's one-shot host decode (`zlibng_tpu_torch/stream/inflate.py`:
decompress_member, decompress, gzip_decompress, inflate_back) against the
JAX package's, replaying test_trace_infback.py (on GH-751/test.txt) and the
decompress/gzip_decompress cases of test_fixtures_fuzz.py. Both packages
take the same streams, each pinned to the same serial-decoder route, and
must give the same bytes, consumed counts, checksums, gzip headers and
error class and text. The trace case compares the trace lines that
compress_cuda and decompress_cuda (device="cpu") write with those of
compress_tpu and decompress_tpu on the same input."""
import gzip
import os
import zlib

import numpy as np
import pytest

from zlibng_tpu import trace as r_trace
from zlibng_tpu.ops import deflate_tpu as r_ops_deflate
from zlibng_tpu.ops.inflate_tpu import decompress_tpu
from zlibng_tpu_torch import compress_cuda, decompress_cuda
from zlibng_tpu_torch import trace as p_trace
from zlibng_tpu_torch.ops import deflate as p_ops_deflate

from test_torch_native import route
from test_torch_stream_api import ROUTES, both, header_fields, outcome
from torch_corpus import FIXTURES, pigz, text


def _raw(data: bytes, wbits: int = -15, zdict: bytes | None = None) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, wbits, 8, 0,
                          *([zdict] if zdict else []))
    return co.compress(data) + co.flush()


DATA = pigz()[:50000]
DCT = pigz()[60000:70000]
STREAMS = {
    "zlib": (lambda: zlib.compress(DATA, 6), 15, None),
    "zlib, window 512 asked 9": (lambda: _raw(DATA, 9), 9, None),
    "zlib, window 512 asked 15": (lambda: _raw(DATA, 9), 15, None),
    "zlib, window 32K asked 9": (lambda: zlib.compress(DATA, 6), 9, None),
    "zlib, wbits 0": (lambda: zlib.compress(DATA, 6), 0, None),
    "raw 15": (lambda: _raw(DATA), -15, None),
    "raw 9": (lambda: _raw(DATA, -9), -9, None),
    "gzip": (lambda: gzip.compress(DATA, mtime=7), 31, None),
    "auto, zlib": (lambda: zlib.compress(DATA, 6), 47, None),
    "auto, gzip": (lambda: gzip.compress(DATA, mtime=7), 47, None),
    "dictionary": (lambda: _raw(DATA, 15, DCT), 15, DCT),
    "dictionary missing": (lambda: _raw(DATA, 15, DCT), 15, None),
    "dictionary wrong": (lambda: _raw(DATA, 15, DCT), 15, b"wrong"),
    "raw with dictionary": (lambda: _raw(DATA, -15, DCT), -15, DCT),
    "zlib, trailing bytes": (lambda: zlib.compress(DATA) + b"xyz", 15, None),
    "zlib, truncated trailer": (lambda: zlib.compress(DATA)[:-2], 15, None),
    "zlib, bad check": (lambda: zlib.compress(DATA)[:-1] + b"\x00", 15,
                        None),
    "zlib, header only": (lambda: b"\x78", 15, None),
    "zlib, FDICT no DICTID": (lambda: b"\x78\xbb", 15, None),
    "zlib, bad header": (lambda: b"\x78\x9d" + bytes(8), 15, None),
    "gzip, bad crc": (lambda: (lambda g: g[:-8] + bytes([g[-8] ^ 1])
                               + g[-7:])(gzip.compress(DATA)), 31, None),
    "gzip, bad length": (lambda: (lambda g: g[:-1] + bytes([g[-1] ^ 1]))(
        gzip.compress(DATA)), 31, None),
    "gzip, truncated": (lambda: gzip.compress(DATA)[:-3], 31, None),
}


def _member(m, name):
    make, wbits, dct = STREAMS[name]
    blob = make()

    def one():
        r = m.inflate.decompress_member(blob, wbits=wbits, dictionary=dct)
        assert type(r.data) is bytes
        return (r.data, r.consumed, r.checksum,
                header_fields(r.gzip_header))

    return (outcome(one), outcome(lambda: m.inflate.decompress(
        blob, wbits=wbits, dictionary=dct)))


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("name", list(STREAMS))
def test_decompress_member_every_wbits(route_name, name):
    with route(route_name):
        member, whole = both(_member, name)
    if member[0] != "raised":
        assert member[0] == whole == DATA
        assert zlib.decompressobj(STREAMS[name][1] or 15, **(
            {"zdict": STREAMS[name][2]} if STREAMS[name][2] else {})
        ).decompress(STREAMS[name][0]()) == DATA


def _multi_member(m, fixtures):
    blob = gzip.compress(b"first|", mtime=1) + gzip.compress(b"second",
                                                            mtime=2)
    padded = blob + bytes(64)
    res = (m.inflate.gzip_decompress(blob), m.inflate.gzip_decompress(padded),
           outcome(lambda: m.inflate.gzip_decompress(blob + b"\x1f")))
    if not fixtures:
        return res
    with open(os.path.join(FIXTURES, "GH-979", "pigz-2.6.tar.gz"), "rb") as f:
        pigz_gz = f.read()
    with open(os.path.join(FIXTURES, "GH-1600", "packobj.gz"), "rb") as f:
        packobj = f.read()
    return res + (m.inflate.gzip_decompress(pigz_gz) == gzip.decompress(
        pigz_gz), m.inflate.decompress(packobj) == zlib.decompress(packobj))


@pytest.mark.parametrize("route_name", ROUTES)
def test_gzip_decompress_multi_member(route_name):
    """Multi-member gzip with zero padding; on the C route also the pigz
    tarball (GH-979) and a zlib pack object (GH-1600)."""
    with route(route_name):
        got = both(_multi_member, route_name == "c")
    assert got[:2] == (b"first|second",) * 2 and all(got[3:])


CVES = ["CVE-2002-0059", "CVE-2004-0797", "CVE-2005-1849", "CVE-2005-2096"]


def _cve(m, cve):
    with open(os.path.join(FIXTURES, cve, "test.gz"), "rb") as f:
        blob = f.read()
    return (outcome(lambda: m.inflate.decompress(blob, wbits=31)),
            outcome(lambda: m.api.Inflate(wbits=31).decompress(
                blob, finish=True)))


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("cve", CVES)
def test_cve_gz_fixtures_rejected_alike(route_name, cve):
    with route(route_name):
        got = both(_cve, cve)
    assert got[0][:2] == got[1][:2] == ("raised", "DataError")


def _mutations(m, seed):
    rng = np.random.default_rng(seed)
    res = []
    for _ in range(20):
        data = rng.integers(0, 4, int(rng.integers(1, 2048)),
                            np.uint8).tobytes()
        comp = bytearray(zlib.compress(data, 6))
        for _ in range(3):
            comp[int(rng.integers(0, len(comp)))] ^= int(rng.integers(1, 256))
        junk = rng.integers(0, 256, int(rng.integers(2, 512)),
                            np.uint8).tobytes()
        res.append((outcome(lambda: m.inflate.decompress(bytes(comp))),
                    outcome(lambda: m.inflate.decompress(junk)),
                    outcome(lambda: m.inflate.decompress(junk, wbits=-15))))
    return res


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_mutations_and_garbage(route_name, seed):
    """Bit-flipped streams and random bytes: the same output or the same
    error text in both packages (the fuzz loop of test_fixtures_fuzz.py,
    seeded)."""
    with route(route_name):
        both(_mutations, seed)


# ---------------------------------------------------------------------------
# inflate_back (infback.c) on GH-751/test.txt
# ---------------------------------------------------------------------------
def _back_window(m, wsize, wbits):
    data = text() if wbits == -15 else text()[:40000]
    raw = _raw(data, wbits)
    chunks = [raw[i:i + 997] for i in range(0, len(raw), 997)]
    it = iter(chunks + [b""])
    window = bytearray(wsize)
    got, sizes = bytearray(), []

    def out_fn(view):
        assert isinstance(view, memoryview) and view.obj is window
        sizes.append(len(view))
        got.extend(view)

    m.inflate.inflate_back(lambda: next(it), out_fn, window=window)
    assert bytes(got) == data
    assert all(s == wsize for s in sizes[:-1]) and 0 < sizes[-1] <= wsize
    assert bytes(window[:sizes[-1]]) == data[-sizes[-1]:]
    return sizes, bytes(window)


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("wsize,wbits", [(1 << 15, -15), (1 << 12, -12)])
def test_inflate_back_caller_window(route_name, wsize, wbits):
    """The writable-window contract: out_fn gets views into the caller's
    buffer, whole windows then one partial tail, and the buffer ends
    holding the last window (32 KiB, and 4 KiB for a 4 KiB stream)."""
    with route(route_name):
        both(_back_window, wsize, wbits)


def _back_bytes(m):
    dict_ = b"the quick brown fox jumps over the lazy dog"
    data = b"the quick brown fox jumps over the lazy dog again and again"
    raw = _raw(data, -15, dict_)
    res = []
    for window in (dict_, None):
        it = iter([raw, b""] if window else [_raw(text()), b""])
        chunks = []
        m.inflate.inflate_back(lambda: next(it), chunks.append,
                               window=window)
        assert all(type(c) is bytes for c in chunks)
        res.append(b"".join(chunks))
    trunc = iter([_raw(text())[:5000], b""])
    res.append(outcome(lambda: m.inflate.inflate_back(
        lambda: next(trunc), lambda b: None)))
    res.append(outcome(lambda: m.inflate.inflate_back(
        lambda: b"", lambda b: None, window=bytearray())))
    return res


@pytest.mark.parametrize("route_name", ROUTES)
def test_inflate_back_bytes_window_and_errors(route_name):
    with route(route_name):
        got = both(_back_bytes)
    assert got[0].endswith(b"again and again") and got[1] == text()


# ---------------------------------------------------------------------------
# trace (the ZLIBNG_TPU_TRACE facility)
# ---------------------------------------------------------------------------
def _traced(trace_mod, fn) -> list:
    lines = []
    trace_mod.enable(True, sink=lines.append)
    try:
        fn()
    finally:
        trace_mod.enable(False, sink=None)
    return [ln.split("] ", 1)[1] for ln in lines]


def _routing(lines: list) -> list:
    """The lines that carry no time: routing and bit accounting."""
    return [ln for ln in lines if not ln.endswith(" ms")]


def test_trace_engine_routing_and_bits():
    data = pigz()[:65536]
    z6 = zlib.compress(data, 6)
    audit = dict(p_ops_deflate.audit)
    ref_audit = dict(r_ops_deflate.audit)

    def port():
        assert zlib.decompress(compress_cuda(data, 6, device="cpu")) == data
        assert decompress_cuda(z6, engine="device", device="cpu") == data
        assert decompress_cuda(z6, engine="host", device="cpu") == data

    def ref():
        assert zlib.decompress(r_ops_deflate.compress_tpu(data, 6)) == data
        assert decompress_tpu(z6, engine="device") == data
        assert decompress_tpu(z6, engine="host") == data

    got, want = _traced(p_trace, port), _traced(r_trace, ref)
    text_ = "\n".join(got)
    assert "inflate route=device" in text_ and "inflate route=host" in text_
    assert "bits_sent=" in text_
    assert _routing(got) == _routing(want)
    moved = {k: p_ops_deflate.audit[k] - audit[k] for k in audit}
    assert moved == {k: r_ops_deflate.audit[k] - ref_audit[k]
                     for k in ref_audit}
    assert moved["groups_checked"] > 0 and moved["bit_overruns"] == 0
    # the timed lines: the port's spans, each with its call id (the
    # reference writes one line per dispatch)
    timed = [ln for ln in got if ln.endswith(" ms")]
    assert all(" call=" in ln for ln in timed)
    assert {ln.split("#")[0] for ln in timed} >= {
        "compress", "frame", "stage1", "stage2", "stage2.partition",
        "stage2.huffman", "stage2.render", "stage2.pack", "stitch",
        "decode", "phase_a", "phase_a.k2", "phase_b"}


def test_trace_disabled_is_silent():
    data = text()[:50000]
    z6 = zlib.compress(data, 6)
    assert _traced(p_trace, lambda: None) == []
    lines = []
    p_trace.enable(False, sink=lines.append)
    try:
        assert decompress_cuda(z6, device="cpu") == data
        compress_cuda(data, 1, device="cpu")
    finally:
        p_trace.enable(False, sink=None)
    assert lines == []
