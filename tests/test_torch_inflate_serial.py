"""The port's carried serial inflater, decode tables and header parsers
against the JAX package's (its numpy paths: the reference's C host runtime
is switched off with `_native_lib = False`) and stdlib zlib. Exact: equal
arrays, bytes, bit positions and error strings."""
import gzip
import zlib

import numpy as np
import pytest

import zlibng_tpu.stream.inflate_serial as ref_ser
from zlibng_tpu.errors import DataError as RefDataError
from zlibng_tpu.format import headers as ref_h
from zlibng_tpu.huffman import decode_tables as ref_dt
from zlibng_tpu_torch.errors import DataError
from zlibng_tpu_torch.format import headers as th
from zlibng_tpu_torch.format.constants import FIXED_LIT_LENGTHS
from zlibng_tpu_torch.huffman import decode_tables as tdt
from zlibng_tpu_torch.huffman.encode import huffman_code_lengths
from zlibng_tpu_torch.stream import inflate_serial as tser

from torch_corpus import crafted_streams, pigz, raw_deflate, sample


@pytest.fixture(autouse=True)
def ref_numpy_path(monkeypatch):
    monkeypatch.setattr(ref_ser, "_native_lib", False)


def _outcome(fn):
    """(result, None) or (None, (exception class name, message))."""
    try:
        return fn(), None
    except (DataError, RefDataError, ValueError, th.NeedMoreInput,
            ref_h.NeedMoreInput) as e:
        return None, (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# decode tables
# ---------------------------------------------------------------------------
def _length_sets():
    rng = np.random.default_rng(5)
    sets = {
        "fixed lit": (FIXED_LIT_LENGTHS.astype(np.int32), tdt.LENS),
        "fixed dist": (np.full(32, 5, np.int32), tdt.DISTS),
        "one code": (np.array([0, 1, 0, 0], np.int32), tdt.DISTS),
        "one code, CODES": (np.array([0, 1, 0, 0], np.int32), tdt.CODES),
        "empty": (np.zeros(30, np.int32), tdt.DISTS),
        "oversubscribed": (np.array([1, 1, 1, 2], np.int32), tdt.LENS),
        "incomplete": (np.array([1, 2, 0, 0], np.int32), tdt.LENS),
        "bl codes": (np.array([2, 2, 3, 3, 3, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0,
                               0, 0, 0, 0], np.int32), tdt.CODES),
    }
    # complete random codes: Huffman lengths of random frequencies
    for i in range(3):
        freqs = rng.integers(0, 50, 286)
        freqs[256] = 1
        sets[f"random {i}"] = (huffman_code_lengths(freqs, 15), tdt.LENS)
    return sets


LENGTH_SETS = _length_sets()


@pytest.mark.parametrize("name", sorted(LENGTH_SETS))
def test_decode_tables_match_reference(name):
    lengths, kind = LENGTH_SETS[name]
    assert _outcome(lambda: tdt.validate_lengths(lengths, kind)) == \
        _outcome(lambda: ref_dt.validate_lengths(lengths, kind))
    got, err = _outcome(lambda: tdt.build_packed_lut(lengths, kind))
    want, ref_err = _outcome(lambda: ref_dt.build_packed_lut(lengths, kind))
    assert err == ref_err
    if want is not None:
        np.testing.assert_array_equal(got, want)
    for max_len in (None, 7, 15):
        got, err = _outcome(lambda: tdt.build_decode_lut(lengths, kind,
                                                         max_len))
        want, ref_err = _outcome(lambda: ref_dt.build_decode_lut(
            lengths, kind, max_len))
        assert err == ref_err
        if want is not None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# header parsers
# ---------------------------------------------------------------------------
def _zlib_head(wbits: int) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, wbits)
    return (co.compress(b"abc") + co.flush())[:2]


ZLIB_HEADERS = {
    "default": _zlib_head(15),
    "wbits 9": _zlib_head(9),
    "fdict": th.build_zlib_header(15, 6, dictid=0x12345678),
    "bad check": b"\x78\x9d",
    "bad method": bytes([0x77, (31 - (0x7700 % 31)) % 31]),
    "bad window": bytes([0x88, (31 - (0x8800 % 31)) % 31]),
    "short": b"\x78",
    "fdict short": th.build_zlib_header(15, 6, dictid=1)[:4],
}


@pytest.mark.parametrize("name", sorted(ZLIB_HEADERS))
def test_zlib_header_parse_matches_reference(name):
    hdr = ZLIB_HEADERS[name]
    assert _outcome(lambda: th.parse_zlib_header(hdr)) == \
        _outcome(lambda: ref_h.parse_zlib_header(hdr))


def _gzip_headers():
    full = th.GzipHeader(text=True, time=123456, os=11, extra=b"ex\x00tra",
                         name=b"file.txt", comment=b"a comment", hcrc=True)
    good = th.build_gzip_header(full, level=9)
    bad_crc = bytearray(good)
    bad_crc[-1] ^= 1
    return {
        "stdlib": gzip.compress(b"abc")[:10],
        "all fields": good,
        "header crc mismatch": bytes(bad_crc),
        "short": good[:9],
        "extra short": good[:13],
        "name open": th.build_gzip_header(th.GzipHeader(name=b"n"))[:-1],
        "bad magic": b"\x1f\x8c" + good[2:],
        "bad method": good[:2] + b"\x07" + good[3:],
        "reserved flags": good[:3] + bytes([good[3] | 0x20]) + good[4:],
    }


GZIP_HEADERS = _gzip_headers()


@pytest.mark.parametrize("name", sorted(GZIP_HEADERS))
def test_gzip_header_parse_matches_reference(name):
    hdr = GZIP_HEADERS[name]
    got, err = _outcome(lambda: th.parse_gzip_header(hdr))
    want, ref_err = _outcome(lambda: ref_h.parse_gzip_header(hdr))
    assert err == ref_err
    if want is not None:
        assert vars(got[0]) == vars(want[0]) and got[1] == want[1]


# ---------------------------------------------------------------------------
# serial inflater
# ---------------------------------------------------------------------------
def _streams():
    data = pigz()[:60000]
    a16, runs = sample("a16", 30000), sample("runs", 40000)
    dct = sample("text", 5000)
    return {
        "L0": (raw_deflate(data, 0), {}, data),
        "L1": (raw_deflate(data, 1), {}, data),
        "L6": (raw_deflate(data, 6), {}, data),
        "L9 a16": (raw_deflate(a16, 9), {}, a16),
        "fixed": (raw_deflate(data, 6, strategy=zlib.Z_FIXED), {}, data),
        "runs": (raw_deflate(runs, 6), {}, runs),
        "wbits 9": (raw_deflate(data, 6, wbits=-9), {"wbits": 9}, data),
        "dictionary": (raw_deflate(data, 6, zdict=dct), {"dictionary": dct},
                       data),
        "empty": (raw_deflate(b""), {}, b""),
    }


STREAMS = _streams()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_inflate_raw_matches_reference_and_zlib(name):
    raw, kw, want = STREAMS[name]
    out, bits = tser.inflate_raw(raw, **kw)
    ref_out, ref_bits = ref_ser.inflate_raw(raw, **kw)
    assert out == bytes(ref_out) == want
    assert bits == ref_bits and (bits + 7) // 8 == len(raw)
    # the same payload behind a 3-byte prefix, through `start`
    assert tser.inflate_raw(b"abc" + raw, start=3, **kw) == (out, bits)


@pytest.mark.parametrize("name", ["L1", "L6", "dictionary"])
def test_inflater_resumes_over_fed_chunks(name):
    raw, kw, want = STREAMS[name]
    inf = tser.RawInflater(**kw)
    for i in range(0, len(raw), 777):
        inf.feed(raw[i:i + 777])
        r = inf.run(finish=False)
        if i + 777 < len(raw):
            assert r == tser.NEED_INPUT
    assert r == tser.STREAM_END
    assert inf.output() == want


def _flips(n: int, seed: int):
    """Seeded corruptions of an L6 stream: half in its dynamic header."""
    base = raw_deflate(pigz()[:20000], 6)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pos = int(rng.integers(0, 80 if i % 2 else len(base)))
        c = bytearray(base)
        c[pos] ^= int(rng.integers(1, 256))
        out.append(bytes(c))
    return out


CRAFTED = crafted_streams()
CRAFTED["truncated"] = raw_deflate(pigz()[:5000])[:50]


@pytest.mark.parametrize("case", [f"flip {i}" for i in range(24)]
                         + sorted(CRAFTED))
def test_error_text_matches_reference(case):
    if case.startswith("flip"):
        raw = _flips(24, 9)[int(case.split()[1])]
    else:
        raw = CRAFTED[case]
    got = _outcome(lambda: tser.inflate_raw(raw))
    want = _outcome(lambda: ref_ser.inflate_raw(raw))
    assert (got[1] is None) == (want[1] is None)
    if got[1] is None:
        assert got[0][0] == bytes(want[0][0]) and got[0][1] == want[0][1]
    else:
        assert got[1][1] == want[1][1]
    if case in CRAFTED and case != "truncated":
        assert got[1][1] == zlib_text(case)


def zlib_text(case: str) -> str:
    """The error string each hand-made stream is built to reach."""
    return {"block type 3": "invalid block type",
            "stored lengths": "invalid stored block lengths",
            "too many symbols": "too many length or distance symbols",
            "truncated stored": "unexpected end of stream",
            "empty input": "unexpected end of stream",
            "distance too far": "invalid distance too far back",
            "missing end-of-block": "invalid code -- missing end-of-block",
            }.get(case, case)


def test_stream_error_strings_match_reference():
    assert tser._STREAM_ERRMSG == ref_ser._STREAM_ERRMSG
    assert (tser.NEED_INPUT, tser.STREAM_END) == (ref_ser.NEED_INPUT,
                                                  ref_ser.STREAM_END)
    assert (tser._S_BLOCK_HEADER, tser._S_STORED, tser._S_HUFF,
            tser._S_DONE) == (ref_ser._S_BLOCK_HEADER, ref_ser._S_STORED,
                              ref_ser._S_HUFF, ref_ser._S_DONE)


def test_dynamic_header_lengths_match_reference(monkeypatch):
    """_last_lengths, which the device decoder turns into its tables. Its
    length differs by route (318 on the C route, hlit + hdist on numpy's,
    in both packages), so the port takes the reference's numpy route."""
    monkeypatch.setattr(tser, "_native_lib", False)
    raw = STREAMS["L6"][0]
    a, b = tser.RawInflater(), ref_ser.RawInflater()
    for inf in (a, b):
        inf.feed(raw)
        inf._read_block_header(True)
    la, ha, da = a._last_lengths
    lb, hb, db = b._last_lengths
    assert (ha, da) == (hb, db)
    np.testing.assert_array_equal(la, lb[:ha + da])
    assert a.bitpos == b.bitpos
    np.testing.assert_array_equal(a.lit_lut, b.lit_lut)
    np.testing.assert_array_equal(a.dist_lut, b.dist_lut)


def test_dynamic_header_lengths_match_reference_on_c_route(monkeypatch):
    """The same header read on the C route of both packages. Its tables
    fill the first 2^lut_bits entries of scratch buffers left unset past
    them."""
    if tser._native() is None:
        pytest.skip("no C compiler: the C route is not built")
    monkeypatch.setattr(ref_ser, "_native_lib", None)
    raw = STREAMS["L6"][0]
    a, b = tser.RawInflater(), ref_ser.RawInflater()
    for inf in (a, b):
        inf.feed(raw)
        inf._read_block_header(True)
    la, ha, da = a._last_lengths
    lb, hb, db = b._last_lengths
    assert (ha, da) == (hb, db) and len(la) == len(lb)
    np.testing.assert_array_equal(la, lb)
    assert a.bitpos == b.bitpos
    assert a._lut_bits == b._lut_bits
    lbits, dbits = a._lut_bits
    np.testing.assert_array_equal(a.lit_lut[:1 << lbits],
                                  b.lit_lut[:1 << lbits])
    np.testing.assert_array_equal(a.dist_lut[:1 << dbits],
                                  b.dist_lut[:1 << dbits])
