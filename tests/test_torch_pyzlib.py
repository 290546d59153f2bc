"""The port's zlib drop-in (`zlibng_tpu_torch.pyzlib`) against stdlib
`zlib` and the JAX package's `pyzlib`, replaying test_pyzlib.py: both
packages take the same calls and must give the same bytes, attributes
(`eof`, `unused_data`, `unconsumed_tail`) and errors, and stdlib zlib must
read what they write and agree on what they read."""
import zlib

import pytest

from test_torch_native import route
from test_torch_stream_api import ROUTES, both, outcome

DATA = (b"the quick brown fox jumps over the lazy dog " * 300
        + bytes(range(256)) * 40)


def _module_functions(m):
    z = m.pyzlib
    res = []
    for level in (-1, 0, 1, 6, 9):
        c = z.compress(DATA, level)
        assert zlib.decompress(c) == DATA
        assert z.decompress(zlib.compress(DATA, max(level, 0))) == DATA
        res.append(c)
    res += [z.compress(bytearray(DATA[:3000]), 5, -15),
            z.compress(memoryview(DATA[:3000]), 5, 31)]
    sums = (z.adler32(DATA), z.adler32(DATA, 99), z.crc32(DATA),
            z.crc32(DATA, 77), z.adler32(b"", -1), z.crc32(b"x", -1))
    assert sums[:4] == (zlib.adler32(DATA), zlib.adler32(DATA, 99),
                        zlib.crc32(DATA), zlib.crc32(DATA, 77))
    return res, sums, z.compressBound(100000)


def test_module_functions():
    both(_module_functions)


def _compressobj(m):
    z = m.pyzlib
    co = z.compressobj(6)
    parts = [co.compress(DATA[i:i + 1000]) for i in range(0, len(DATA), 1000)]
    parts.append(co.flush())
    assert zlib.decompress(b"".join(parts)) == DATA
    co = z.compressobj(6)
    a = co.compress(DATA[:5000]) + co.flush(z.Z_SYNC_FLUSH)
    assert a.endswith(b"\x00\x00\xff\xff")
    b = co.compress(DATA[5000:]) + co.flush(z.Z_NO_FLUSH) + co.flush()
    assert zlib.decompress(a + b) == DATA
    do = zlib.decompressobj()
    co = z.compressobj(6)
    sync = b""
    for i in range(0, 12000, 3000):       # chunked, a sync flush each
        piece = co.compress(DATA[i:i + 3000]) + co.flush(z.Z_SYNC_FLUSH)
        assert do.decompress(piece) == DATA[i:i + 3000]
        sync += piece
    co = z.compressobj(6, z.DEFLATED, -15)
    raw = co.compress(DATA) + co.flush()
    assert zlib.decompress(raw, -15) == DATA
    return parts, a, b, sync, raw


def test_compressobj_streaming_and_flush_modes():
    both(_compressobj)


def _zdict(m, route_name):
    z = m.pyzlib
    zdict = DATA[:3000]
    co = z.compressobj(6, z.DEFLATED, 15, 8, z.Z_DEFAULT_STRATEGY, zdict)
    c = co.compress(DATA) + co.flush()
    do = zlib.decompressobj(zdict=zdict)
    assert do.decompress(c) + do.flush() == DATA
    co2 = zlib.compressobj(6, zlib.DEFLATED, 15, 8, 0, zdict)
    c2 = co2.compress(DATA) + co2.flush()
    with route(route_name):
        do2 = z.decompressobj(zdict=zdict)
        out = do2.decompress(c2) + do2.flush()
        no_dict = outcome(lambda: z.decompressobj().decompress(c2))
    assert out == DATA
    return c, no_dict


@pytest.mark.parametrize("route_name", ROUTES)
def test_compressobj_zdict(route_name):
    got = both(_zdict, route_name)
    assert got[1][:2] == ("raised", "NeedDictError")


def _dribble(m, route_name):
    z = m.pyzlib
    zc = zlib.compress(DATA, 6) + b"TRAILING"
    with route(route_name):
        do = z.decompressobj()
        out = b"".join(do.decompress(zc[i:i + 500])
                       for i in range(0, len(zc), 500))
        out += do.flush()
    assert out == DATA and do.eof and do.unused_data == b"TRAILING"
    return do.eof, do.unused_data, do.unconsumed_tail


@pytest.mark.parametrize("route_name", ROUTES)
def test_decompressobj_dribble_eof_unused(route_name):
    both(_dribble, route_name)


def _max_length(m, route_name, limit):
    z = m.pyzlib
    zc = zlib.compress(DATA, 9)
    sizes = []
    with route(route_name):
        do = z.decompressobj()
        out = bytearray()
        chunk = do.decompress(zc, limit)
        out += chunk
        while chunk:
            assert len(chunk) <= limit
            sizes.append((len(chunk), len(do.unconsumed_tail)))
            chunk = do.decompress(do.unconsumed_tail, limit)
            out += chunk
        out += do.flush()
    assert bytes(out) == DATA and do.eof
    std = zlib.decompressobj()
    assert std.decompress(zc, limit) == bytes(out[:limit])
    return sizes


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("limit", [1, 777])
def test_decompressobj_max_length_loop(route_name, limit):
    both(_max_length, route_name, limit)


def _truncated(m, route_name):
    zc = zlib.compress(DATA, 6)
    with route(route_name):
        ours = m.pyzlib.decompressobj()
        o1 = ours.decompress(zc[:50])
        std = zlib.decompressobj()
        assert o1 == std.decompress(zc[:50])
        assert ours.flush() == std.flush() == b""
    return o1, ours.eof


@pytest.mark.parametrize("route_name", ROUTES)
def test_decompressobj_flush_on_truncated_matches_stdlib(route_name):
    both(_truncated, route_name)


def _copy(m, route_name):
    z = m.pyzlib
    co = z.compressobj(6)
    head = co.compress(DATA[:4000])
    co2 = co.copy()
    tail1 = co.compress(DATA[4000:]) + co.flush()
    tail2 = co2.compress(DATA[4000:]) + co2.flush()
    assert tail1 == tail2 and zlib.decompress(head + tail1) == DATA
    zc = zlib.compress(DATA, 6)
    with route(route_name):
        do = z.decompressobj()
        h = do.decompress(zc[:1000])
        do2 = do.copy()
        t1 = do.decompress(zc[1000:]) + do.flush()
        t2 = do2.decompress(zc[1000:]) + do2.flush()
    assert h + t1 == DATA and t1 == t2
    return head, tail1, h


@pytest.mark.parametrize("route_name", ROUTES)
def test_copy_semantics(route_name):
    both(_copy, route_name)


def _errors(m):
    z = m.pyzlib
    res = [outcome(lambda: z.decompress(b"\x78\x9c" + b"\x00" * 8)),
           outcome(lambda: z.decompress(b"\x78\x9c")),
           outcome(lambda: z.decompress(zlib.compress(DATA)[:-1])),
           outcome(lambda: z.compressobj(6, 9)),
           outcome(lambda: z.compressobj(10))]
    assert issubclass(z.error, Exception)
    for r in res:
        assert r[0] == "raised"
    try:
        z.decompress(b"\x78\x9c" + b"\x00" * 8)
    except z.error:
        pass
    assert z.compressBound(40000) >= len(z.compress(b"\x00" * 40000, 9))
    return res


def test_error_compat():
    both(_errors)


def test_constants_match_stdlib_and_reference():
    def consts(m):
        return {n: getattr(m.pyzlib, n) for n in m.pyzlib.__all__
                if n.isupper() or n.startswith(("Z_", "DEF", "MAX"))}

    got = both(consts)
    for name in ("Z_NO_FLUSH", "Z_PARTIAL_FLUSH", "Z_SYNC_FLUSH",
                 "Z_FULL_FLUSH", "Z_FINISH", "Z_BLOCK", "Z_TREES",
                 "Z_DEFAULT_COMPRESSION", "Z_BEST_SPEED",
                 "Z_BEST_COMPRESSION", "Z_DEFAULT_STRATEGY", "Z_FILTERED",
                 "Z_HUFFMAN_ONLY", "Z_RLE", "Z_FIXED", "DEFLATED",
                 "DEF_MEM_LEVEL", "DEF_BUF_SIZE", "MAX_WBITS"):
        assert got[name] == getattr(zlib, name), name
