"""zlib (RFC 1950) and gzip (RFC 1952) framing: header and trailer build
and parse.

A copy of `zlibng_tpu/format/headers.py`: the write side (zlib-ng
deflate.c:866-1031) and the read side (inflate.c:509-719).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

from ..checksum.crc32 import crc32
from ..errors import DataError
from .constants import (
    GZIP_MAGIC, GZIP_OS_UNIX, GZ_FCOMMENT, GZ_FEXTRA, GZ_FHCRC, GZ_FNAME,
    GZ_FTEXT, ZLIB_METHOD_DEFLATE,
)


class FormatError(DataError):
    """Malformed wrapper data (maps to Z_DATA_ERROR)."""


class NeedMoreInput(Exception):
    """Header incomplete; feed more bytes (maps to Z_BUF_ERROR/again)."""


def build_zlib_header(wbits: int = 15, level: int = 6,
                      dictid: int | None = None) -> bytes:
    """CMF/FLG pair (+DICTID), with FCHECK making the pair a multiple of 31."""
    cmf = (ZLIB_METHOD_DEFLATE | ((wbits - 8) << 4)) & 0xFF
    if level < 2:
        level_flags = 0
    elif level < 6:
        level_flags = 1
    elif level == 6:
        level_flags = 2
    else:
        level_flags = 3
    flg = level_flags << 6
    if dictid is not None:
        flg |= 0x20  # FDICT
    header = (cmf << 8) | flg
    if header % 31:
        header += 31 - (header % 31)
    out = struct.pack(">H", header)
    if dictid is not None:
        out += struct.pack(">I", dictid)
    return out


def parse_zlib_header(data: bytes):
    """Returns (wbits, has_dict, dictid_or_None, consumed). Raises on bad
    CMF/FLG (inflate.c HEAD state checks)."""
    if len(data) < 2:
        raise NeedMoreInput
    cmf, flg = data[0], data[1]
    if ((cmf << 8) | flg) % 31 != 0:
        raise FormatError("incorrect header check")
    if (cmf & 0x0F) != ZLIB_METHOD_DEFLATE:
        raise FormatError("unknown compression method")
    wbits = (cmf >> 4) + 8
    if wbits > 15:
        raise FormatError("invalid window size")
    has_dict = bool(flg & 0x20)
    dictid = None
    consumed = 2
    if has_dict:
        if len(data) < 6:
            raise NeedMoreInput
        dictid = struct.unpack(">I", data[2:6])[0]
        consumed = 6
    return wbits, has_dict, dictid, consumed


@dataclass
class GzipHeader:
    """Mirror of zng_gz_header (zlib-ng.h.in:127-141)."""
    text: bool = False
    time: int = 0
    xflags: int = 0
    os: int = GZIP_OS_UNIX
    extra: bytes | None = None
    name: bytes | None = None
    comment: bytes | None = None
    hcrc: bool = False
    done: bool = True  # read side: header complete


def build_gzip_header(h: GzipHeader | None = None, level: int = 6) -> bytes:
    h = h or GzipHeader()
    flg = 0
    if h.text:
        flg |= GZ_FTEXT
    if h.hcrc:
        flg |= GZ_FHCRC
    if h.extra is not None:
        flg |= GZ_FEXTRA
    if h.name is not None:
        flg |= GZ_FNAME
    if h.comment is not None:
        flg |= GZ_FCOMMENT
    xfl = h.xflags or (4 if level < 2 else (2 if level == 9 else 0))
    out = bytearray(GZIP_MAGIC)
    out.append(ZLIB_METHOD_DEFLATE)
    out.append(flg)
    out += struct.pack("<I", h.time & 0xFFFFFFFF)
    out.append(xfl & 0xFF)
    out.append(h.os & 0xFF)
    if h.extra is not None:
        out += struct.pack("<H", len(h.extra))
        out += h.extra
    if h.name is not None:
        out += h.name.rstrip(b"\x00") + b"\x00"
    if h.comment is not None:
        out += h.comment.rstrip(b"\x00") + b"\x00"
    if h.hcrc:
        out += struct.pack("<H", crc32(bytes(out)) & 0xFFFF)
    return bytes(out)


def parse_gzip_header(data: bytes):
    """Returns (GzipHeader, consumed). Validates magic, method, FHCRC
    (inflate.c:509-696 gzip states)."""
    if len(data) < 10:
        raise NeedMoreInput
    if data[:2] != GZIP_MAGIC:
        raise FormatError("incorrect header check")
    if data[2] != ZLIB_METHOD_DEFLATE:
        raise FormatError("unknown compression method")
    flg = data[3]
    if flg & 0xE0:
        raise FormatError("unknown header flags set")
    h = GzipHeader(
        text=bool(flg & GZ_FTEXT),
        time=struct.unpack("<I", data[4:8])[0],
        xflags=data[8],
        os=data[9],
        hcrc=bool(flg & GZ_FHCRC),
    )
    pos = 10
    if flg & GZ_FEXTRA:
        if len(data) < pos + 2:
            raise NeedMoreInput
        xlen = struct.unpack("<H", data[pos:pos + 2])[0]
        pos += 2
        if len(data) < pos + xlen:
            raise NeedMoreInput
        h.extra = bytes(data[pos:pos + xlen])
        pos += xlen
    if flg & GZ_FNAME:
        end = data.find(b"\x00", pos)
        if end < 0:
            raise NeedMoreInput
        h.name = bytes(data[pos:end])
        pos = end + 1
    if flg & GZ_FCOMMENT:
        end = data.find(b"\x00", pos)
        if end < 0:
            raise NeedMoreInput
        h.comment = bytes(data[pos:end])
        pos = end + 1
    if flg & GZ_FHCRC:
        if len(data) < pos + 2:
            raise NeedMoreInput
        expect = struct.unpack("<H", data[pos:pos + 2])[0]
        got = crc32(bytes(data[:pos])) & 0xFFFF
        if expect != got:
            raise FormatError("header crc mismatch")
        pos += 2
    return h, pos


def build_gzip_trailer(crc: int, isize: int) -> bytes:
    return struct.pack("<II", crc & 0xFFFFFFFF, isize & 0xFFFFFFFF)


def build_zlib_trailer(adler: int) -> bytes:
    return struct.pack(">I", adler & 0xFFFFFFFF)
