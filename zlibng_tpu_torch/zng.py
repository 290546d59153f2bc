"""The literal zng_-named entry points of zlib-ng's exported surface.

A copy of `zlibng_tpu/zng.py`: every function zlib-ng exports (its
declarations cited to zlib-ng.h.in at each wrapper) under its exact name.
Where C uses out-pointers these return data and values, and errors raise
(StreamError, DataError) instead of returning negative codes. Stream state
lives in the Deflate and Inflate objects of stream/api.py (the zng_stream
analog). Everything here runs on the host.
"""
from __future__ import annotations

import numpy as np

from . import ZLIBNG_PARITY_VERSION, __version__
from .checksum.adler32 import adler32 as _adler32
from .checksum.adler32 import adler32_combine as _adler32_combine
from .checksum.crc32 import crc32 as _crc32
from .checksum.crc32 import crc32_combine as _crc32_combine
from .checksum.crc32 import crc32_combine_gen as _crc32_combine_gen
from .checksum.crc32 import crc32_combine_op as _crc32_combine_op
from .format import headers as H
from .stream.api import Deflate, Inflate, Z_FINISH, Z_NO_FLUSH
from .stream.deflate import compress as _compress, compress_bound as _bound
from .stream.gzfile import GzFile
from .stream.gzfile import gzdopen as _gzdopen
from .stream.gzfile import gzopen as _gzopen
from .stream.inflate import decompress as _uncompress
from .stream.inflate import decompress_member as _decompress_member
from .stream.inflate import inflate_back as _inflate_back

__all__ = []  # filled at bottom


def zlibng_version() -> str:
    """zlib-ng.h.in:221."""
    return f"{__version__} (capability parity: zlib-ng {ZLIBNG_PARITY_VERSION})"


# ---------------------------------------------------------------------------
# basic + advanced deflate (zlib-ng.h.in:228-361, 540-815; deflate.c)
# ---------------------------------------------------------------------------
def zng_deflateInit(level: int = -1) -> Deflate:
    """zlib-ng.h.in:228."""
    return zng_deflateInit2(level)


def zng_deflateInit2(level: int = -1, method: int = 8, windowBits: int = 15,
                     memLevel: int = 8, strategy: int = 0) -> Deflate:
    """zlib-ng.h.in:540; validation per deflate.c:306-326."""
    return Deflate(level=6 if level == -1 else level, method=method,
                   wbits=windowBits, mem_level=memLevel, strategy=strategy)


def zng_deflate(strm: Deflate, data: bytes = b"",
                flush: int = Z_NO_FLUSH) -> bytes:
    """zlib-ng.h.in:249 (semantics doc :250-361). Returns produced bytes."""
    return strm.compress(data, flush)


def zng_deflateEnd(strm: Deflate) -> None:
    """zlib-ng.h.in:363 (state is GC'd; kept for call-site parity)."""


def zng_deflateSetDictionary(strm: Deflate, dictionary: bytes) -> None:
    """zlib-ng.h.in:606; deflate.c:456-512."""
    strm.set_dictionary(dictionary)


def zng_deflateGetDictionary(strm: Deflate) -> bytes:
    """zlib-ng.h.in:649."""
    return strm.get_dictionary()


def zng_deflateCopy(source: Deflate) -> Deflate:
    """zlib-ng.h.in:670; deflate.c:1131-1180."""
    return source.copy()


def zng_deflateReset(strm: Deflate) -> None:
    """zlib-ng.h.in:688."""
    strm.reset()


def zng_deflateResetKeep(strm: Deflate) -> None:
    """zlib-ng.h.in:1858; deflate.c:534-570 (buffers are reused here too)."""
    strm.reset()


def zng_deflateParams(strm: Deflate, level: int, strategy: int) -> None:
    """zlib-ng.h.in:700; deflate.c:636-676."""
    strm.params(level, strategy)


def zng_deflateTune(strm: Deflate, good_length: int, max_lazy: int,
                    nice_length: int, max_chain: int) -> None:
    """zlib-ng.h.in:737; deflate.c:679-690."""
    strm.tune(good_length, max_lazy, nice_length, max_chain)


def zng_deflateBound(strm: Deflate | None, sourceLen: int) -> int:
    """zlib-ng.h.in:751; deflate.c:709-781 (tight when the stream is
    known, conservative + zlib wrapper otherwise)."""
    if strm is None:
        return _bound(sourceLen, 15) + 6
    return strm.bound(sourceLen)


def zng_deflatePending(strm: Deflate) -> tuple[int, int]:
    """zlib-ng.h.in:766 → (pending_bytes, pending_bits)."""
    return strm.pending()


def zng_deflatePrime(strm: Deflate, bits: int, value: int) -> None:
    """zlib-ng.h.in:780; deflate.c:600-633."""
    strm.prime(bits, value)


def zng_deflateSetHeader(strm: Deflate, head: H.GzipHeader) -> None:
    """zlib-ng.h.in:796."""
    strm.set_header(head)


# zlib-ng parameter API (zlib-ng.h.in:1802-1842)
Z_DEFLATE_LEVEL = 0
Z_DEFLATE_STRATEGY = 1
Z_DEFLATE_REPRODUCIBLE = 2


class zng_deflate_param:
    """zlib-ng.h.in:1802-1812 enum; values usable in Set/GetParams dicts."""
    Z_DEFLATE_LEVEL = Z_DEFLATE_LEVEL
    Z_DEFLATE_STRATEGY = Z_DEFLATE_STRATEGY
    Z_DEFLATE_REPRODUCIBLE = Z_DEFLATE_REPRODUCIBLE


def zng_deflateSetParams(strm: Deflate, params: dict) -> None:
    """zlib-ng.h.in:1822; keys: level/strategy/reproducible. Output here is
    always a pure function of (input, parameters), so reproducible=True is
    accepted and False is meaningless-but-valid."""
    strm.params(params.get("level", strm.level),
                params.get("strategy", strm.strategy))


def zng_deflateGetParams(strm: Deflate) -> dict:
    """zlib-ng.h.in:1842."""
    return {"level": strm.level, "strategy": strm.strategy,
            "reproducible": True}


# ---------------------------------------------------------------------------
# basic + advanced inflate (zlib-ng.h.in:378-520, 821-1152; inflate.c)
# ---------------------------------------------------------------------------
def zng_inflateInit(wbits: int = 15) -> Inflate:
    """zlib-ng.h.in:378."""
    return Inflate(wbits=wbits)


def zng_inflateInit2(windowBits: int = 15) -> Inflate:
    """zlib-ng.h.in:821; wrap decoding per inflate.c:104-135."""
    return Inflate(wbits=windowBits)


def zng_inflate(strm: Inflate, data: bytes = b"",
                flush: int = Z_NO_FLUSH) -> bytes:
    """zlib-ng.h.in:401 (semantics doc :402-520). Returns produced bytes.
    Z_BLOCK/Z_TREES stop at block boundaries / after block headers and
    report position via strm.data_type (inflate.c:476-520)."""
    return strm.decompress(data, flush=flush)


def zng_inflateEnd(strm: Inflate) -> None:
    """zlib-ng.h.in:522."""


def zng_inflateSetDictionary(strm: Inflate, dictionary: bytes) -> None:
    """zlib-ng.h.in:873."""
    strm.set_dictionary(dictionary)


def zng_inflateGetDictionary(strm: Inflate) -> bytes:
    """zlib-ng.h.in:895."""
    return strm.get_dictionary()


def zng_inflateSync(strm: Inflate) -> bool:
    """zlib-ng.h.in:909; inflate.c:1308-1366 (00 00 FF FF scan)."""
    return strm.sync()


def zng_inflateSyncPoint(strm: Inflate) -> bool:
    """zlib-ng.h.in:1852."""
    return strm.sync_point()


def zng_inflateCopy(source: Inflate) -> Inflate:
    """zlib-ng.h.in:929; inflate.c:1379-1413."""
    return source.copy()


def zng_inflateReset(strm: Inflate) -> None:
    """zlib-ng.h.in:945."""
    strm.reset()


def zng_inflateReset2(strm: Inflate, windowBits: int) -> None:
    """zlib-ng.h.in:957."""
    strm.reset(windowBits)


def zng_inflateResetKeep(strm: Inflate) -> None:
    """zlib-ng.h.in:1857."""
    strm.reset()


def zng_inflatePrime(strm: Inflate, bits: int, value: int) -> None:
    """zlib-ng.h.in:971; inflate.c:277-302."""
    strm.prime(bits, value)


def zng_inflateMark(strm: Inflate) -> int:
    """zlib-ng.h.in:991 → (input_mark << 16) | output_distance, packed like
    the reference's long return."""
    in_mark, out_dist = strm.mark()
    return (in_mark << 16) | (out_dist & 0xFFFF)


def zng_inflateGetHeader(strm: Inflate) -> H.GzipHeader | None:
    """zlib-ng.h.in:1020; populated once the gzip header has been parsed."""
    return strm.get_header()


def zng_inflateCodesUsed(strm: Inflate) -> int:
    """zlib-ng.h.in:1856."""
    return strm.codes_used()


def zng_inflateValidate(strm: Inflate, check: bool) -> None:
    """zlib-ng.h.in:1855; inflate.c:1429-1442."""
    strm.validate(check)


def zng_inflateUndermine(strm: Inflate, subvert: bool) -> None:
    """zlib-ng.h.in:1854 (distance-validity subversion is refused, like
    builds without INFLATE_ALLOW_INVALID_DISTANCE)."""
    strm.undermine(subvert)


def zng_inflateBackInit(window: bytes | None = None):
    """zlib-ng.h.in:1060; user-supplied window per infback.c:34-71.
    Returns an opaque state to pass to zng_inflateBack."""
    return {"window": window, "used": False}


def zng_inflateBack(state, in_fn, out_fn) -> None:
    """zlib-ng.h.in:1083; pull-model raw-deflate decode (infback.c:152-513).
    in_fn() -> bytes chunk ('' = EOF); out_fn(bytes) consumes output."""
    if state["used"]:
        raise ValueError("inflateBack state already consumed")
    state["used"] = True
    _inflate_back(in_fn, out_fn, window=state["window"])


def zng_inflateBackEnd(state) -> None:
    """zlib-ng.h.in:1152."""


def zng_zlibCompileFlags() -> int:
    """zlib-ng.h.in:1161-1199 bit layout (zutil.c zlibCompileFlags): two-bit
    type sizes (01=32-bit, 10=64-bit) for uint/ulong/void*/z_off_t; all
    option bits 8..31 are 0 for this build (no debug/ASM/WINAPI, tables are
    precomputed, full gzip support, secure formatting)."""
    import struct
    szs = (4,                              # unsigned int
           struct.calcsize("l"),           # unsigned long
           struct.calcsize("P"),           # void *
           8)                              # z_off_t (64-bit offsets)
    flags = 0
    for shift, sz in zip((0, 2, 4, 6), szs):
        flags |= {2: 0, 4: 1, 8: 2}.get(sz, 3) << shift
    return flags


# ---------------------------------------------------------------------------
# one-shot (compress.c:31-98, uncompr.c:25-80)
# ---------------------------------------------------------------------------
def zng_compress(source: bytes, level: int = -1) -> bytes:
    """zlib-ng.h.in:1214."""
    return _compress(source, level=6 if level == -1 else level)


def zng_compress2(source: bytes, level: int) -> bytes:
    """zlib-ng.h.in:1229."""
    return _compress(source, level=level)


def zng_compressBound(sourceLen: int) -> int:
    """zlib-ng.h.in:1244."""
    return _bound(sourceLen, 15)


def zng_uncompress(source: bytes) -> bytes:
    """zlib-ng.h.in:1252."""
    return _uncompress(source)


def zng_uncompress2(source: bytes) -> tuple[bytes, int]:
    """zlib-ng.h.in:1271 → (output, source_bytes_consumed)."""
    r = _decompress_member(source, wbits=15)
    return r.data, r.consumed


# ---------------------------------------------------------------------------
# checksums (zlib-ng.h.in:1692-1774)
# ---------------------------------------------------------------------------
def zng_adler32(adler: int, data: bytes | None = None) -> int:
    """zlib-ng.h.in:1692 (NULL buf → initial value 1, like the C API)."""
    if data is None:
        return 1
    return _adler32(data, adler)


def zng_adler32_z(adler: int, data: bytes | None = None) -> int:
    """zlib-ng.h.in:1713."""
    return zng_adler32(adler, data)


def zng_adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """zlib-ng.h.in:1719; adler32.c:32-55."""
    return _adler32_combine(adler1, adler2, len2)


def zng_crc32(crc: int, data: bytes | None = None) -> int:
    """zlib-ng.h.in:1730 (NULL buf → initial value 0)."""
    if data is None:
        return 0
    return _crc32(data, crc)


def zng_crc32_z(crc: int, data: bytes | None = None) -> int:
    """zlib-ng.h.in:1749."""
    return zng_crc32(crc, data)


def zng_crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib-ng.h.in:1755; crc32_braid_comb.c:16-24."""
    return _crc32_combine(crc1, crc2, len2)


def zng_crc32_combine_gen(len2: int) -> int:
    """zlib-ng.h.in:1766."""
    return _crc32_combine_gen(len2)


def zng_crc32_combine_op(crc1: int, crc2: int, op: int) -> int:
    """zlib-ng.h.in:1774."""
    return _crc32_combine_op(crc1, crc2, op)


def zng_get_crc_table() -> np.ndarray:
    """zlib-ng.h.in:1853."""
    from .format.constants import CRC_TABLE
    return CRC_TABLE


def zng_zError(err: int) -> str:
    """zlib-ng.h.in:1851; strings per zutil.c z_errmsg."""
    return {
        0: "", 1: "stream end", 2: "need dictionary",
        -1: "file error", -2: "stream error", -3: "data error",
        -4: "insufficient memory", -5: "buffer error",
        -6: "incompatible version",
    }.get(err, "unknown error")


# ---------------------------------------------------------------------------
# gzFile layer (zlib-ng.h.in:1292-1674; gzlib.c/gzread.c.in/gzwrite.c)
# ---------------------------------------------------------------------------
def zng_gzopen(path, mode: str = "rb", **kw) -> GzFile:
    """zlib-ng.h.in:1292."""
    return _gzopen(path, mode, **kw)


def zng_gzopen_w(path, mode: str = "wb", **kw) -> GzFile:
    """zlib-ng.h.in:1862 (wide-char Windows variant; paths here are
    unicode-native already)."""
    return _gzopen(path, mode, **kw)


def zng_gzdopen(fd: int, mode: str = "rb", **kw) -> GzFile:
    """zlib-ng.h.in:1330."""
    return _gzdopen(fd, mode, **kw)


def zng_gzbuffer(file: GzFile, size: int) -> None:
    """zlib-ng.h.in:1354."""
    file.buffer(size)


def zng_gzsetparams(file: GzFile, level: int, strategy: int = 0) -> None:
    """zlib-ng.h.in:1371."""
    file.set_params(level, strategy)


def zng_gzread(file: GzFile, n: int) -> bytes:
    """zlib-ng.h.in:1383."""
    return file.read(n)


def zng_gzfread(file: GzFile, size: int, nitems: int) -> bytes:
    """zlib-ng.h.in:1414 (returns the bytes; len//size = items read)."""
    return file.read(size * nitems)


def zng_gzwrite(file: GzFile, data: bytes) -> int:
    """zlib-ng.h.in:1438."""
    return file.write(data)


def zng_gzfwrite(file: GzFile, data: bytes, size: int, nitems: int) -> int:
    """zlib-ng.h.in:1445 → items written."""
    written = file.write(data[: size * nitems])
    return written // size if size else 0


def zng_gzprintf(file: GzFile, fmt: str, *args) -> int:
    """zlib-ng.h.in:1457."""
    return file.printf(fmt, *args)


def zng_gzvprintf(file: GzFile, fmt: str, args) -> int:
    """zlib-ng.h.in:1864 (va_list analog: an iterable of arguments)."""
    return file.printf(fmt, *args)


def zng_gzputs(file: GzFile, s) -> int:
    """zlib-ng.h.in:1473."""
    return file.puts(s)


def zng_gzgets(file: GzFile, maxlen: int = 65536) -> bytes:
    """zlib-ng.h.in:1482."""
    return file.gets(maxlen)


def zng_gzputc(file: GzFile, c: int) -> int:
    """zlib-ng.h.in:1497."""
    return file.putc(c)


def zng_gzgetc(file: GzFile) -> int:
    """zlib-ng.h.in:1504 (and the gzgetc macro :1791-1799)."""
    return file.getc()


def zng_gzungetc(c: int, file: GzFile) -> int:
    """zlib-ng.h.in:1514 (argument order matches the C prototype)."""
    return file.ungetc(c)


def zng_gzflush(file: GzFile, flush: int) -> None:
    """zlib-ng.h.in:1527."""
    file.flush(flush)


def zng_gzseek(file: GzFile, offset: int, whence: int = 0) -> int:
    """zlib-ng.h.in:1543."""
    return file.seek(offset, whence)


def zng_gzrewind(file: GzFile) -> None:
    """zlib-ng.h.in:1562."""
    file.rewind()


def zng_gztell(file: GzFile) -> int:
    """zlib-ng.h.in:1570."""
    return file.tell()


def zng_gzoffset(file: GzFile) -> int:
    """zlib-ng.h.in:1581."""
    return file.offset()


def zng_gzeof(file: GzFile) -> bool:
    """zlib-ng.h.in:1591."""
    return file.eof()


def zng_gzdirect(file: GzFile) -> bool:
    """zlib-ng.h.in:1607."""
    return file.direct()


def zng_gzclose(file: GzFile) -> None:
    """zlib-ng.h.in:1629."""
    file.close()


def zng_gzclose_r(file: GzFile) -> None:
    """zlib-ng.h.in:1643."""
    file.close()


def zng_gzclose_w(file: GzFile) -> None:
    """zlib-ng.h.in:1645."""
    file.close()


def zng_gzerror(file: GzFile) -> tuple[str, int]:
    """zlib-ng.h.in:1657 → (message, errnum) like the C string return +
    errnum out-param."""
    return file.error()


def zng_gzclearerr(file: GzFile) -> None:
    """zlib-ng.h.in:1674."""
    file.clearerr()


__all__ = [n for n in dir() if n.startswith("zng_") or n in (
    "zlibng_version", "Z_DEFLATE_LEVEL", "Z_DEFLATE_STRATEGY",
    "Z_DEFLATE_REPRODUCIBLE")]
