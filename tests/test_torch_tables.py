"""Host-side copies of the PyTorch port against the JAX package's modules:
format tables, level table, headers, checksums, errors, tracing, host bit
packing and the bit stitcher. Tolerance: none."""
import zlib
from dataclasses import asdict

import numpy as np
import pytest

from zlibng_tpu import errors as ref_errors
from zlibng_tpu.checksum.adler32 import adler32 as ref_adler32
from zlibng_tpu.checksum.crc32 import crc32 as ref_crc32
from zlibng_tpu.format import constants as RC
from zlibng_tpu.format import headers as RH
from zlibng_tpu.huffman.bitpack import pack_bits as ref_pack_bits
from zlibng_tpu.lz77 import engine as ref_engine
from zlibng_tpu.ops.deflate_tpu import _BitStitcher as RefStitcher
from zlibng_tpu.stream import deflate as ref_deflate
from zlibng_tpu_torch import errors, trace
from zlibng_tpu_torch.checksum.adler32 import adler32
from zlibng_tpu_torch.checksum.crc32 import crc32
from zlibng_tpu_torch.format import constants as TC
from zlibng_tpu_torch.format import headers as TH
from zlibng_tpu_torch.huffman.bitpack import pack_bits
from zlibng_tpu_torch.lz77 import engine
from zlibng_tpu_torch.ops import deflate as tdef
from zlibng_tpu_torch.stream import deflate as tdeflate

from torch_corpus import sample

ARRAYS = ["BL_ORDER", "LENGTH_EXTRA", "LENGTH_BASE", "DIST_EXTRA", "DIST_BASE",
          "FIXED_LIT_LENGTHS", "FIXED_LIT_CODES", "FIXED_DIST_LENGTHS",
          "FIXED_DIST_CODES", "FIXED_LIT_CODES_REV", "FIXED_DIST_CODES_REV",
          "CRC_TABLES", "CRC_TABLE"]
SCALARS = ["MIN_MATCH", "MAX_MATCH", "MAX_BITS", "MAX_BL_BITS", "MAX_WBITS",
           "WINDOW_SIZE", "REP_3_6", "REPZ_3_10", "REPZ_11_138", "ADLER_BASE",
           "ADLER_NMAX", "CRC_POLY", "ZLIB_METHOD_DEFLATE", "GZIP_MAGIC",
           "GZIP_OS_UNIX"]


@pytest.mark.parametrize("name", ARRAYS)
def test_table_equal(name):
    a, b = getattr(TC, name), getattr(RC, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_scalars_and_window_rule_equal():
    for name in SCALARS:
        assert getattr(TC, name) == getattr(RC, name), name
    for wbits in list(range(-15, -7)) + list(range(8, 16)) + [0, 16, 24, 31]:
        assert TC.effective_window(wbits) == RC.effective_window(wbits)
    lens = np.random.default_rng(0).integers(0, 16, 300)
    np.testing.assert_array_equal(TC.canonical_codes(lens),
                                  RC.canonical_codes(lens))
    assert engine.HASH_MULT == int(ref_engine.HASH_MULT)
    assert engine.TOO_FAR == ref_engine.TOO_FAR


def test_levels_and_strategies_equal():
    assert set(tdeflate.LEVELS) == set(ref_deflate.LEVELS)
    for lv, cfg in ref_deflate.LEVELS.items():
        assert asdict(tdeflate.LEVELS[lv]) == asdict(cfg)
        assert tdeflate.level_config_from(cfg) == tdeflate.LEVELS[lv]
    for name in ("Z_DEFAULT_STRATEGY", "Z_FILTERED", "Z_HUFFMAN_ONLY",
                 "Z_RLE", "Z_FIXED"):
        assert getattr(tdeflate, name) == getattr(ref_deflate, name)


def test_stage_geometry_equal():
    from zlibng_tpu.ops import deflate_tpu as ref
    for name in ("LANE_HIST", "LANE_BLOCKS", "UNIT", "OUT_BUCKETS",
                 "_UP_BUCKETS", "HDR_OUT"):
        assert getattr(tdef, name) == getattr(ref, name), name


def test_headers_equal():
    for wbits in range(8, 16):
        for level in range(0, 10):
            for dictid in (None, 0xDEADBEEF):
                assert TH.build_zlib_header(wbits, level, dictid) == \
                    RH.build_zlib_header(wbits, level, dictid)
    for level in (1, 6, 9):
        assert TH.build_gzip_header(level=level) == \
            RH.build_gzip_header(level=level)
    h = dict(text=True, time=12345, extra=b"xy", name=b"f.txt",
             comment=b"c", hcrc=True)
    assert TH.build_gzip_header(TH.GzipHeader(**h)) == \
        RH.build_gzip_header(RH.GzipHeader(**h))
    assert TH.build_gzip_trailer(0x1234ABCD, 1 << 33) == \
        RH.build_gzip_trailer(0x1234ABCD, 1 << 33)
    assert TH.build_zlib_trailer(0xCAFEBABE) == \
        RH.build_zlib_trailer(0xCAFEBABE)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 4099, 70000])
def test_checksums_equal(n):
    data = sample("a256", n, seed=n)
    assert adler32(data) == ref_adler32(data) == zlib.adler32(data)
    assert adler32(data, 12345) == zlib.adler32(data, 12345)
    assert crc32(data[:5000]) == ref_crc32(data[:5000]) == \
        zlib.crc32(data[:5000])
    arr = np.frombuffer(data, np.uint8)
    assert adler32(arr) == zlib.adler32(data)


def test_errors_and_trace():
    for name in ("Error", "DataError", "StreamError", "BufError",
                 "NeedDictError"):
        t, r = getattr(errors, name), getattr(ref_errors, name)
        assert [c.__name__ for c in t.__mro__] == \
            [c.__name__ for c in r.__mro__]
    assert errors.StreamError("x").msg == "x"
    assert errors.NeedDictError(7).adler == 7
    lines = []
    try:
        trace.enable(True, sink=lines.append)
        with trace.call("test", lambda c: None) as call:
            with trace.span("stage", group=1):
                pass
        trace.trace("hello %s", "port")
    finally:
        trace.enable(False)
    assert lines[0].startswith(f"[zlibng_tpu_torch] test#0 call={call.id} "
                               "host=")
    assert lines[1].startswith(f"[zlibng_tpu_torch] stage#1 call={call.id} "
                               "group=1 parent=test#0 host=")
    assert lines[1].endswith(" ms")
    assert lines[2] == "[zlibng_tpu_torch] hello port"
    trace.trace("silent")
    assert len(lines) == 3


def test_pack_bits_and_stitcher_equal():
    rng = np.random.default_rng(3)
    nb = rng.integers(0, 49, 500)
    vals = rng.integers(0, 1 << 48, 500, dtype=np.uint64) & \
        ((np.uint64(1) << nb.astype(np.uint64)) - np.uint64(1))
    a, abits = pack_bits(vals, nb)
    b, bbits = ref_pack_bits(vals, nb)
    assert abits == bbits
    np.testing.assert_array_equal(a, b)
    s, r = tdef._BitStitcher(), RefStitcher()
    for _ in range(60):
        bits = int(rng.integers(0, 200))
        part = rng.integers(0, 256, (bits + 7) // 8 + 3, dtype=np.uint8)
        if bits & 7:
            part[(bits - 1) // 8] &= (1 << (bits & 7)) - 1
        s.append(part, bits)
        r.append(part, bits)
        tok = [(int(rng.integers(0, 8)), 3), (0x1F, 5)]
        s.append_tokens(tok)
        r.append_tokens(tok)
    assert s.bits == r.bits and s.getvalue() == r.getvalue()
