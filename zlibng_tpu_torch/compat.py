"""zlib-ng-compatible functional API: a copy of `zlibng_tpu/compat.py`.

The zng_ names (`from .zng import *`) plus snake-case names over the
Pythonic core, so users of zlib-ng find every entry point. Stream-object
methods cover the rest:

  zng_deflateInit/Init2        -> deflate_init
  zng_deflate                  -> Deflate.compress (flush constants match)
  zng_deflateEnd               -> (GC; Deflate.close no-op)
  zng_deflateSetDictionary     -> Deflate.set_dictionary
  zng_deflateGetDictionary     -> Deflate.get_dictionary
  zng_deflateCopy              -> Deflate.copy
  zng_deflateReset/ResetKeep   -> Deflate.reset
  zng_deflateParams            -> Deflate.params
  zng_deflateTune              -> Deflate.tune
  zng_deflateBound             -> deflate_bound / Deflate.bound
  zng_deflatePending           -> Deflate.pending
  zng_deflatePrime             -> Deflate.prime
  zng_deflateSetHeader         -> Deflate.set_header
  zng_deflateSetParams/GetParams -> deflate_set_params / deflate_get_params
  zng_inflateInit/Init2        -> inflate_init
  zng_inflate                  -> Inflate.decompress
  zng_inflateSetDictionary     -> Inflate.set_dictionary
  zng_inflateGetDictionary     -> Inflate.get_dictionary
  zng_inflateSync/SyncPoint    -> Inflate.sync / Inflate.sync_point
  zng_inflateCopy              -> Inflate.copy
  zng_inflateReset/Reset2      -> Inflate.reset
  zng_inflatePrime             -> Inflate.prime
  zng_inflateMark              -> Inflate.mark
  zng_inflateGetHeader         -> Inflate.get_header
  zng_inflateCodesUsed         -> Inflate.codes_used
  zng_compress/compress2       -> compress / compress2
  zng_compressBound            -> compress_bound
  zng_uncompress/uncompress2   -> uncompress / uncompress2
  zng_adler32/_z/_combine      -> adler32 / adler32_combine
  zng_crc32/_z/_combine/_gen/_op -> crc32 / crc32_combine(_gen/_op)
  zng_gz*                      -> stream.gzfile.GzFile / gzopen / gzdopen
  zlibng_version               -> zlibng_version
  zng_zlibCompileFlags         -> zlib_compile_flags
  zng_zError                   -> z_error
"""
from __future__ import annotations

from .zng import *  # noqa: F401,F403  (literal zng_-named entry points)
from . import ZLIBNG_PARITY_VERSION, __version__
from .checksum.adler32 import adler32, adler32_combine
from .checksum.crc32 import crc32, crc32_combine, crc32_combine_gen, crc32_combine_op
from .stream.api import Deflate, Inflate
from .stream.deflate import compress as _compress_oneshot, compress_bound
from .stream.inflate import decompress as _decompress_oneshot

# zlib-ng parameter API (zlib-ng.h.in:1802-1812)
Z_DEFLATE_LEVEL = 0
Z_DEFLATE_STRATEGY = 1
Z_DEFLATE_REPRODUCIBLE = 2

_ERROR_STRINGS = {
    0: "", 1: "stream end", 2: "need dictionary",
    -1: "file error", -2: "stream error", -3: "data error",
    -4: "insufficient memory", -5: "buffer error",
    -6: "incompatible version",
}


def zlibng_version() -> str:
    return f"{__version__} (capability parity: zlib-ng {ZLIBNG_PARITY_VERSION})"


def z_error(code: int) -> str:
    """zng_zError."""
    return _ERROR_STRINGS.get(code, "unknown error")


def zlib_compile_flags() -> int:
    """zng_zlibCompileFlags analog: sizes are fixed in this implementation
    (2: uInt 32-bit sizes reported per the reference bit layout)."""
    return 0x55  # 4-byte uInt/uLong/voidpf/z_off_t markers


def deflate_init(level: int = -1, method: int = 8, wbits: int = 15,
                 mem_level: int = 8, strategy: int = 0) -> Deflate:
    return Deflate(level=level, method=method, wbits=wbits,
                   mem_level=mem_level, strategy=strategy)


def inflate_init(wbits: int = 15) -> Inflate:
    return Inflate(wbits=wbits)


def deflate_bound(n: int, wbits: int = 15) -> int:
    return compress_bound(n, wbits)


def deflate_set_params(strm: Deflate, **params) -> None:
    """zng_deflateSetParams: Z_DEFLATE_LEVEL / _STRATEGY / _REPRODUCIBLE.
    (This implementation is always reproducible: output is a pure function
    of input + parameters — the Z_DEFLATE_REPRODUCIBLE contract holds.)"""
    level = params.get("level", strm.level)
    strategy = params.get("strategy", strm.strategy)
    strm.params(level, strategy)


def deflate_get_params(strm: Deflate) -> dict:
    return {"level": strm.level, "strategy": strm.strategy,
            "reproducible": True}


# ---------------------------------------------------------------------------
# one-shot (compress.c / uncompr.c)
# ---------------------------------------------------------------------------
def compress(data: bytes, level: int = -1) -> bytes:
    """zng_compress."""
    return _compress_oneshot(data, level=6 if level == -1 else level)


def compress2(data: bytes, level: int) -> bytes:
    """zng_compress2."""
    return _compress_oneshot(data, level=level)


def uncompress(data: bytes, wbits: int = 15) -> bytes:
    """zng_uncompress."""
    return _decompress_oneshot(data, wbits=wbits)


def uncompress2(data: bytes, wbits: int = 15):
    """zng_uncompress2: returns (output, bytes_consumed)."""
    from .stream.inflate import decompress_member
    r = decompress_member(data, wbits=wbits)
    return r.data, r.consumed


def adler32_z(data, value: int = 1) -> int:
    return adler32(data, value)


def crc32_z(data, value: int = 0) -> int:
    return crc32(data, value)


def get_crc_table():
    """zng_get_crc_table."""
    from .format.constants import CRC_TABLE
    return CRC_TABLE
