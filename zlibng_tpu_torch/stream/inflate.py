"""Wrapper-aware one-shot decompression: zlib, gzip, raw and auto-detect.

A copy of `zlibng_tpu/stream/inflate.py` (zlib-ng inflateInit2 windowBits
semantics, inflate.c:104-135): wbits 8..15 zlib, -8..-15 raw, +16 gzip,
+32 auto-detect zlib or gzip. Checks the adler32 and the crc32 + ISIZE
trailers (inflate.c:1109-1153) and takes preset dictionaries (DICTID,
inflate.c:646-672). Decoding is the serial decoder's (`inflate_serial`,
C route first); `inflate_back` is the callback-pull decode of infback.c.
"""
from __future__ import annotations

import struct

from ..checksum.adler32 import adler32
from ..checksum.crc32 import crc32
from ..format import headers as H
from .inflate_serial import InflateError, RawInflater, inflate_raw

__all__ = ["decompress", "DecompressResult", "InflateError"]


class DecompressResult:
    """Output plus stream metadata (total_in/out, checksum, gzip header)."""

    def __init__(self, data: bytes, consumed: int, checksum: int | None,
                 gzip_header: H.GzipHeader | None = None):
        # the compat surface promises real bytes (inflate_raw's C route
        # hands back a zero-copy memoryview; the surface that avoids this
        # copy is ops/inflate.decompress_cuda)
        self.data = data if isinstance(data, bytes) else bytes(data)
        self.consumed = consumed       # bytes of input consumed (this member)
        self.checksum = checksum
        self.gzip_header = gzip_header


def decompress_member(data: bytes, wbits: int = 15,
                      dictionary: bytes | None = None) -> DecompressResult:
    """Decompress a single zlib/gzip/raw member, verifying trailers.

    One-shot surface: a header truncated mid-field (e.g. FDICT set but no
    DICTID bytes) is a hard error here, unlike the streaming Inflate class
    where NeedMoreInput means 'feed me more' (inflate.c one-shot callers
    see Z_DATA_ERROR for the same streams)."""
    try:
        return _decompress_member(data, wbits=wbits, dictionary=dictionary)
    except H.NeedMoreInput:
        raise InflateError("unexpected end of stream") from None


def _decompress_member(data: bytes, wbits: int = 15,
                       dictionary: bytes | None = None) -> DecompressResult:
    if wbits < 0:
        # raw deflate
        out, bits = inflate_raw(data, wbits=-wbits, dictionary=dictionary)
        return DecompressResult(out, (bits + 7) // 8, None)

    gz_header = None
    if wbits >= 32:  # auto-detect
        from ..format.constants import GZIP_MAGIC
        is_gzip = data[:2] == GZIP_MAGIC
        wbits = (wbits & 15) + (16 if is_gzip else 0)

    if wbits >= 16:  # gzip
        gz_header, pos = H.parse_gzip_header(data)
        out, bits = inflate_raw(data[pos:], wbits=wbits - 16 or 15)
        pos += (bits + 7) // 8
        if len(data) < pos + 8:
            raise InflateError("unexpected end of stream")
        expect_crc, expect_isize = struct.unpack("<II", data[pos:pos + 8])
        got_crc = crc32(out)
        if got_crc != expect_crc:
            raise InflateError("incorrect data check")
        if expect_isize != (len(out) & 0xFFFFFFFF):
            raise InflateError("incorrect length check")
        return DecompressResult(out, pos + 8, got_crc, gz_header)

    # zlib
    hwbits, has_dict, dictid, pos = H.parse_zlib_header(data)
    if wbits and hwbits > wbits:
        # requested window smaller than the stream's (inflate.c:638-644)
        raise InflateError("invalid window size")
    if has_dict:
        if dictionary is None:
            raise InflateError("preset dictionary needed")
        if adler32(dictionary) != dictid:
            raise InflateError("incorrect dictionary")
    out, bits = inflate_raw(data[pos:], wbits=max(hwbits, 8),
                            dictionary=dictionary if has_dict else None)
    pos += (bits + 7) // 8
    if len(data) < pos + 4:
        raise InflateError("unexpected end of stream")
    expect = struct.unpack(">I", data[pos:pos + 4])[0]
    got = adler32(out)
    if got != expect:
        raise InflateError("incorrect data check")
    return DecompressResult(out, pos + 4, got)


def decompress(data: bytes, wbits: int = 15,
               dictionary: bytes | None = None) -> bytes:
    """zlib.decompress-compatible one-shot (single member; gzip multi-member
    concatenation handled at the gzFile layer)."""
    return decompress_member(data, wbits=wbits, dictionary=dictionary).data


def inflate_back(in_fn, out_fn, window=None) -> None:
    """zng_inflateBack analog (reference infback.c:34-513): raw-deflate
    callback-pull decoding. `in_fn()` returns the next input chunk (b'' at
    end); `out_fn` consumes output.

    `window` selects the delivery contract:
      * a WRITABLE buffer (bytearray / writable memoryview) is the
        caller-owned sliding window of infback.c:34-71: the decoder fills
        it from offset 0, calls `out_fn(memoryview_into_window)` each time
        it fills completely (and once at stream end with the partial
        tail) — output is delivered as views INTO the caller's buffer
        with no per-chunk allocation, and after return the buffer holds
        the final window contents, exactly like the C contract.
      * immutable bytes pre-seed history (dictionary-style shim, kept for
        compatibility); None = plain streaming; both deliver bytes chunks.
    """
    writable = isinstance(window, (bytearray, memoryview)) and \
        not (isinstance(window, memoryview) and window.readonly)
    if writable:
        win = memoryview(window)
        wsize = len(win)
        if wsize == 0:
            raise ValueError("inflateBack window must be non-empty")
        inf = RawInflater()
        emitted = 0      # bytes handed to out_fn
        put = 0          # fill cursor within the window
        while True:
            chunk = in_fn()
            done = not chunk
            if chunk:
                inf.feed(chunk)
            r = inf.run(finish=done)
            # deliver produced bytes through the caller's window: fill to
            # the end of the window, flush, repeat (infback.c put/left)
            while len(inf.out) - emitted >= wsize - put:
                take = wsize - put
                win[put:] = inf.out[emitted:emitted + take]
                emitted += take
                put = 0
                out_fn(win[:])
            if r == "stream_end":
                rem = len(inf.out) - emitted
                if rem:
                    win[put:put + rem] = inf.out[emitted:]
                    out_fn(win[put:put + rem])
                    put += rem
                return
            if done:
                raise InflateError("unexpected end of stream")

    inf = RawInflater(dictionary=window)
    emitted = inf.dict_len
    while True:
        chunk = in_fn()
        done = not chunk
        if chunk:
            inf.feed(chunk)
        r = inf.run(finish=done)
        if len(inf.out) > emitted:
            out_fn(bytes(inf.out[emitted:]))
            emitted = len(inf.out)
        if r == "stream_end":
            return
        if done:
            raise InflateError("unexpected end of stream")


def gzip_decompress(data: bytes) -> bytes:
    """Decompress all members of a (possibly multi-member) gzip stream."""
    out = bytearray()
    pos = 0
    while pos < len(data):
        r = decompress_member(data[pos:], wbits=31)
        out += r.data
        pos += r.consumed
        # tolerate trailing zero padding (gzip spec allows, gzread does)
        if pos < len(data) and not any(data[pos:]):
            break
    return bytes(out)
