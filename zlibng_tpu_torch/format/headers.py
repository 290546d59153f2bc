"""zlib (RFC 1950) and gzip (RFC 1952) framing: header and trailer build.

The write side of `zlibng_tpu/format/headers.py` (zlib-ng deflate.c:866-1031).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

from ..checksum.crc32 import crc32
from .constants import (
    GZIP_MAGIC, GZIP_OS_UNIX, GZ_FCOMMENT, GZ_FEXTRA, GZ_FHCRC, GZ_FNAME,
    GZ_FTEXT, ZLIB_METHOD_DEFLATE,
)


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


@dataclass
class GzipHeader:
    """Mirror of zng_gz_header (zlib-ng.h.in:127-141), write-side fields."""
    text: bool = False
    time: int = 0
    xflags: int = 0
    os: int = GZIP_OS_UNIX
    extra: bytes | None = None
    name: bytes | None = None
    comment: bytes | None = None
    hcrc: bool = False


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


def build_gzip_trailer(crc: int, isize: int) -> bytes:
    return struct.pack("<II", crc & 0xFFFFFFFF, isize & 0xFFFFFFFF)


def build_zlib_trailer(adler: int) -> bytes:
    return struct.pack(">I", adler & 0xFFFFFFFF)
