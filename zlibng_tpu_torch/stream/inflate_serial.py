"""Serial (host) DEFLATE decoder: the format-exact conformance path.

The port's copy of `zlibng_tpu/stream/inflate_serial.py` (zlib-ng
inflate.c:476-1201, inftrees.c, inffast_tpl.h): all three block types,
dynamic table construction with the exact error acceptance rules, distance
validation, preset dictionaries, resumable state over fed input, and the
Z_BLOCK/Z_TREES stops. Two routes, as in the reference:

  * the host runtime's C engine (`native/zng_host.c`) when it is built:
    `zng_inflate_stream` decodes whole streams over two-level tables, and
    the one-shot `inflate_raw` returns a zero-copy memoryview into a
    per-thread warm buffer;
  * the numpy/Python route otherwise (or with `_native_lib = False`): block
    at a time over a flat 15-bit LUT (one lookup per symbol), stored blocks
    and LZ77 copies as bulk slices. It is the behavioural specification.

The device decoder (ops/inflate.py) parses block headers with it and reruns
a stream here when it needs zlib's exact error text. Error message strings
match zlib's exactly on both routes.
"""
from __future__ import annotations

import threading

import numpy as np

from .. import native
from ..format.constants import (
    BL_ORDER, DIST_BASE, DIST_EXTRA, FIXED_LIT_LENGTHS, LENGTH_BASE,
    LENGTH_EXTRA,
)
from ..huffman.decode_tables import (
    CODES, DISTS, LENS, InvalidCodeError, build_decode_lut, build_packed_lut,
)


from ..errors import DataError as InflateError  # Z_DATA_ERROR; zlib .msg


# Decoder progress results
NEED_INPUT = "need_input"
STREAM_END = "stream_end"
BLOCK_BOUNDARY = "block_boundary"  # Z_BLOCK stop: a block just completed
TREES_DONE = "trees"               # Z_TREES stop: block header just parsed

# Internal states
_S_BLOCK_HEADER = 0
_S_STORED = 1
_S_HUFF = 2
_S_DONE = 3

# Python-list tables for the serial hot loop (scalar list indexing beats
# numpy scalar indexing ~10x in CPython)
_LB = LENGTH_BASE.tolist()
_LE = LENGTH_EXTRA.tolist()
_DB = DIST_BASE.tolist()
_DE = DIST_EXTRA.tolist()


def _pack_lut(lut) -> np.ndarray:
    """Pack (sym, nbits) decode arrays into one int32 array: entry =
    sym<<4 | nbits. Invalid entries are negative. This layout is shared
    by the native hot loop (zng_decode_huff), the device batch decoder
    (ops/inflate.py) and — via a lazily cached .tolist() — the pure
    Python fallback loop."""
    sym, bits = lut
    return ((sym.astype(np.int64) << 4) | bits).astype(np.int32)


# Fixed tables, built once. The fixed distance tree is defined over 32
# five-bit codes (RFC 1951 §3.2.6); symbols 30/31 are rejected at decode.
# They are filled on the numpy route (equal to zng_fill_lut's), so that
# importing this module compiles nothing.
_FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)
_FIXED_LIT_LUT = _pack_lut(build_decode_lut(FIXED_LIT_LENGTHS, LENS, 15))
_FIXED_DIST_LUT = _pack_lut(build_decode_lut(_FIXED_DIST_LENGTHS, DISTS, 15))
_FIXED_LUT_LIST = (_FIXED_LIT_LUT.tolist(), _FIXED_DIST_LUT.tolist())
# Native-width fixed tables (the hot loop masks by table width, so the
# 9-bit lit / 5-bit dist tables stay L1-resident)
_FIXED_LIT_LUT9 = _pack_lut(build_decode_lut(FIXED_LIT_LENGTHS, LENS, 9))
_FIXED_DIST_LUT5 = _pack_lut(build_decode_lut(_FIXED_DIST_LENGTHS, DISTS, 5))


_native_lib = None


def _native():
    """The compiled host runtime (native/zng_host.c) or None. The serial
    hot loop runs there when available; the Python loop below is the
    always-available fallback and the behavioral specification."""
    global _native_lib
    if _native_lib is None:
        _native_lib = native.lib() or False
    return _native_lib or None


class RawInflater:
    """Raw DEFLATE decoder over an append-only input buffer.

    feed() bytes, then run(finish=...) until STREAM_END. Decoded output
    accumulates in .out (bytearray); .bitpos tracks consumed input bits
    (the inflatePrime/inflateMark analog: sub-byte position is exposed).
    """

    def __init__(self, wbits: int = 15, dictionary: bytes | None = None):
        self.window_size = 1 << wbits
        self.out = bytearray()
        self.dict_len = 0
        if dictionary:
            d = dictionary[-self.window_size:]
            self.out += d
            self.dict_len = len(d)
        self.data = bytearray()
        self.bitpos = 0
        self.state = _S_BLOCK_HEADER
        self.final_block = False
        self.stored_remaining = 0
        self.lit_lut = None
        self._lut_bufs = None  # reused native LUT buffers (dynamic blocks)
        self.dist_lut = None
        self._lut_bits = (15, 15)  # table widths for the native peek masks
        self._last_lengths = None  # (lengths, hlit, hdist) of last dyn block
        self._lut_list = None  # cached list LUTs for the Python fallback
        self.codes_used = 0  # inflateCodesUsed analog: symbols decoded
        # whole-stream native engine state (zng_inflate_stream): resumable
        # int64 slots + persistent two-level table buffers. _tbl2_active
        # means the current _S_HUFF block's tables live there (and NOT in
        # lit_lut/dist_lut) — the flat per-block path and the device
        # decoder's _parse_header always repopulate lit_lut themselves.
        self._st2 = None
        self._tbl2 = None
        self._tbl2_active = False

    # -- bit plumbing -------------------------------------------------------
    def _bits_avail(self) -> int:
        return len(self.data) * 8 - self.bitpos

    def _peek(self, n: int) -> int:
        bp = self.bitpos
        byte = bp >> 3
        off = bp & 7
        need = (n + off + 7) >> 3
        chunk = bytes(self.data[byte:byte + need])
        return (int.from_bytes(chunk, "little") >> off) & ((1 << n) - 1)

    def _get(self, n: int) -> int:
        v = self._peek(n)
        self.bitpos += n
        return v

    def feed(self, chunk: bytes) -> None:
        # one-shot fast path: adopt the caller's bytes object zero-copy;
        # converted to a bytearray on the first append (streaming callers)
        if not self.data and type(chunk) is bytes:
            self.data = chunk
        elif type(self.data) is bytes:
            self.data = bytearray(self.data)
            self.data += chunk
        else:
            self.data += chunk

    def _dptr(self):
        """(c_void_p, keepalive) over self.data without copying; the native
        kernels only read it, so an immutable bytes buffer is fine."""
        import ctypes
        if type(self.data) is bytes:
            return (ctypes.cast(ctypes.c_char_p(self.data), ctypes.c_void_p),
                    self.data)
        anchor = ctypes.c_char.from_buffer(self.data)
        return ctypes.c_void_p(ctypes.addressof(anchor)), anchor

    def output(self) -> bytes:
        """Decoded bytes (excluding any preset dictionary prefix)."""
        if self.dict_len == 0:
            return bytes(self.out)
        return bytes(memoryview(self.out)[self.dict_len:])

    # -- main loop ----------------------------------------------------------
    def run(self, finish: bool = False, stop: str | None = None) -> str:
        """Decode until out of input (NEED_INPUT) or final block done
        (STREAM_END). Raises InflateError on corrupt data; if `finish` and
        input is exhausted mid-stream, raises InflateError('unexpected end').

        stop — Z_BLOCK/Z_TREES analog (inflate.c:722,746,773,920):
        'block' returns BLOCK_BOUNDARY when a block completes during this
        call (never on entry — inflate.c:501 promotes TYPE to TYPEDO so a
        stopped stream resumes); 'trees' additionally returns TREES_DONE
        right after any block header is parsed, before block data."""
        lib = _native()
        if lib is not None and stop is None:
            # whole-stream engine. A block mid-decoded by the flat path is
            # finished there first (its tables live in lit_lut, not in the
            # stream engine's two-level buffers).
            if self.state == _S_HUFF and not self._tbl2_active:
                r = self._decode_huff(finish)
                if r is NEED_INPUT:
                    if finish:
                        raise InflateError("unexpected end of stream")
                    return NEED_INPUT
                if self.state == _S_DONE:
                    return STREAM_END
            r = self._run_stream_native(lib, finish)
            if r is not _TBL2_OVERFLOW:
                return r
            # unreachable for valid streams: continue on the flat path
        elif (lib is not None and stop is not None and self._tbl2_active
                and self.state == _S_HUFF):
            # a stream-engine call left a block mid-decoded; finish it
            # there, which lands exactly on the next block boundary
            r = self._run_stream_native(lib, finish, stop_after_block=True)
            if r is not _TBL2_OVERFLOW:
                return r
        while True:
            if self.state == _S_DONE:
                return STREAM_END
            if self.state == _S_BLOCK_HEADER:
                r = self._read_block_header(finish)
                if r is not NEED_INPUT and stop == "trees" \
                        and self.state in (_S_HUFF, _S_STORED):
                    return TREES_DONE
            elif self.state == _S_STORED:
                r = self._copy_stored(finish)
            else:
                r = self._decode_huff(finish)
            if r is NEED_INPUT:
                if finish:
                    raise InflateError("unexpected end of stream")
                return NEED_INPUT
            if stop is not None and self.state == _S_BLOCK_HEADER:
                return BLOCK_BOUNDARY  # EOB consumed, output flushed

    def _run_stream_native(self, lib, finish: bool,
                           stop_after_block: bool = False):
        """Drive zng_inflate_stream (native block loop over two-level
        tables) from the current state; syncs the Python-visible state
        fields both ways so flat-path and stop-mode calls can interleave."""
        import ctypes

        if self._st2 is None:
            self._st2 = np.zeros(8, np.int64)
            self._tbl2 = (np.empty(1 << 13, np.int32),
                          np.empty(1 << 13, np.int32))
        st = self._st2
        st[0] = self.state
        st[1] = 1 if self.final_block else 0
        st[2] = self.stored_remaining
        lit_tbl, dist_tbl = self._tbl2
        out = self.out
        real = len(out)
        bp = ctypes.c_long(self.bitpos)
        ol = ctypes.c_long(real)
        nc = ctypes.c_long(0)
        # initial output slack: ~4x the remaining compressed bytes (typical
        # DEFLATE expands 2-4x; the retry loop doubles on underestimate).
        # np.empty is uninitialized — extend copies once with no memset pass.
        grow = max(1 << 12, min((len(self.data) - (self.bitpos >> 3)) * 4,
                                1 << 24))
        while True:
            out.extend(np.empty(grow, np.uint8).data)
            grow *= 2
            dptr, danchor = self._dptr()
            oanchor = ctypes.c_char.from_buffer(out)
            ret = lib.zng_inflate_stream(
                dptr, len(self.data),
                ctypes.byref(bp), ctypes.c_void_p(st.ctypes.data),
                ctypes.c_void_p(lit_tbl.ctypes.data), lit_tbl.size,
                ctypes.c_void_p(dist_tbl.ctypes.data), dist_tbl.size,
                ctypes.c_void_p(ctypes.addressof(oanchor)), len(out),
                ctypes.byref(ol), self.window_size, int(finish),
                ctypes.byref(nc), int(stop_after_block))
            del danchor, oanchor
            real = ol.value
            if ret != 2:
                break
        del out[real:]
        self.bitpos = bp.value
        self.codes_used += nc.value
        self.state = int(st[0])
        self.final_block = bool(st[1])
        self.stored_remaining = int(st[2])
        self._tbl2_active = self.state == _S_HUFF
        if ret == 0:
            return STREAM_END
        if ret == 1:
            if finish:
                raise InflateError("unexpected end of stream")
            return NEED_INPUT
        if ret == 3:
            return BLOCK_BOUNDARY
        if ret == -13:
            return _TBL2_OVERFLOW
        raise InflateError(_STREAM_ERRMSG[ret])

    def _read_block_header(self, finish: bool):
        if self._bits_avail() < 3:
            return NEED_INPUT
        self._tbl2_active = False  # flat path takes table ownership
        save = self.bitpos
        self.final_block = bool(self._get(1))
        btype = self._get(2)
        if btype == 0:
            # stored: align, LEN/NLEN
            self.bitpos = (self.bitpos + 7) & ~7
            if self._bits_avail() < 32:
                self.bitpos = save
                return NEED_INPUT
            length = self._get(16)
            nlen = self._get(16)
            if length != (~nlen & 0xFFFF):
                raise InflateError("invalid stored block lengths")
            self.stored_remaining = length
            self.state = _S_STORED
        elif btype == 1:
            if _native() is not None:
                self.lit_lut = _FIXED_LIT_LUT9
                self.dist_lut = _FIXED_DIST_LUT5
                self._lut_bits = (9, 5)
            else:
                self.lit_lut = _FIXED_LIT_LUT
                self.dist_lut = _FIXED_DIST_LUT
                self._lut_bits = (15, 15)
            self._lut_list = _FIXED_LUT_LIST
            self.state = _S_HUFF
        elif btype == 2:
            r = self._read_dynamic_tables(save)
            if r is NEED_INPUT:
                return NEED_INPUT
            self._lut_list = None
            self.state = _S_HUFF
        else:
            raise InflateError("invalid block type")
        return None

    def _read_dynamic_tables(self, save: int):
        lib = _native()
        if lib is not None:
            return self._read_dynamic_tables_native(lib, save)
        # Conservative availability bound: header is at most
        # 14 + 19*3 + 288*(7+7) + 30*(7+7) bits; rather than sizing exactly,
        # roll back and retry whenever bits run out mid-parse.
        try:
            if self._bits_avail() < 14:
                raise _Rollback
            hlit = self._get(5) + 257
            hdist = self._get(5) + 1
            hclen = self._get(4) + 4
            if hlit > 286 or hdist > 30:
                raise InflateError("too many length or distance symbols")
            if self._bits_avail() < 3 * hclen:
                raise _Rollback
            cl_lengths = np.zeros(19, dtype=np.int32)
            for i in range(hclen):
                cl_lengths[BL_ORDER[i]] = self._get(3)
            try:
                cl_sym, cl_bits = build_decode_lut(cl_lengths, CODES,
                                                   max_len=7)
            except InvalidCodeError:
                raise InflateError("invalid code lengths set")
            lengths = np.zeros(hlit + hdist, dtype=np.int32)
            n = 0
            while n < hlit + hdist:
                if self._bits_avail() < 7 + 7:
                    raise _Rollback
                p = self._peek(7)
                sym = int(cl_sym[p])
                nb = int(cl_bits[p])
                if sym < 0:
                    raise InflateError("invalid code lengths set")
                self.bitpos += nb
                if sym < 16:
                    lengths[n] = sym
                    n += 1
                elif sym == 16:
                    if n == 0:
                        raise InflateError("invalid bit length repeat")
                    rep = 3 + self._get(2)
                    if n + rep > hlit + hdist:
                        raise InflateError("invalid bit length repeat")
                    lengths[n:n + rep] = lengths[n - 1]
                    n += rep
                elif sym == 17:
                    rep = 3 + self._get(3)
                    if n + rep > hlit + hdist:
                        raise InflateError("invalid bit length repeat")
                    n += rep
                else:
                    rep = 11 + self._get(7)
                    if n + rep > hlit + hdist:
                        raise InflateError("invalid bit length repeat")
                    n += rep
            if lengths[256] == 0:
                raise InflateError("invalid code -- missing end-of-block")
            try:
                self.lit_lut = build_packed_lut(lengths[:hlit], LENS,
                                                max_len=15)
            except InvalidCodeError:
                raise InflateError("invalid literal/lengths set")
            try:
                self.dist_lut = build_packed_lut(lengths[hlit:], DISTS,
                                                 max_len=15)
            except InvalidCodeError:
                raise InflateError("invalid distances set")
            self._lut_bits = (15, 15)
            self._last_lengths = (lengths, hlit, hdist)
            return None
        except _Rollback:
            self.bitpos = save
            return NEED_INPUT

    def _read_dynamic_tables_native(self, lib, save: int):
        """Header parse + table validation + LUT fill in one call into the
        compiled host runtime (zng_read_dyn_header); error codes map to the
        exact zlib strings of the Python parser."""
        import ctypes

        if self._lut_bufs is None:
            self._lut_bufs = (np.empty(1 << 15, dtype=np.int32),
                              np.empty(1 << 15, dtype=np.int32))
        lit_buf, dist_buf = self._lut_bufs
        lengths = np.zeros(318, dtype=np.int32)
        lut_bits = np.zeros(2, dtype=np.int32)
        bp = ctypes.c_long(self.bitpos)
        hlit = ctypes.c_long(0)
        hdist = ctypes.c_long(0)
        dbuf, _anchor = self._dptr()
        ret = lib.zng_read_dyn_header(
            dbuf, len(self.data), ctypes.byref(bp),
            ctypes.c_void_p(lengths.ctypes.data),
            ctypes.byref(hlit), ctypes.byref(hdist),
            ctypes.c_void_p(lit_buf.ctypes.data),
            ctypes.c_void_p(dist_buf.ctypes.data),
            ctypes.c_void_p(lut_bits.ctypes.data))
        del dbuf
        if ret == 1:
            self.bitpos = save
            return NEED_INPUT
        if ret < 0:
            raise InflateError({
                -1: "too many length or distance symbols",
                -6: "invalid code lengths set",
                -7: "invalid bit length repeat",
                -8: "invalid code -- missing end-of-block",
                -9: "invalid literal/lengths set",
                -10: "invalid distances set"}[ret])
        self.bitpos = bp.value
        self.lit_lut = lit_buf
        self.dist_lut = dist_buf
        self._lut_bits = (int(lut_bits[0]), int(lut_bits[1]))
        # retained for the device decoder: it rebuilds flat LUTs ON DEVICE
        # from the canonical description (ops/inflate._parse_header)
        self._last_lengths = (lengths, int(hlit.value), int(hdist.value))
        return None

    def _copy_stored(self, finish: bool):
        assert self.bitpos % 8 == 0
        byte = self.bitpos >> 3
        avail = len(self.data) - byte
        take = min(avail, self.stored_remaining)
        if take:
            self.out += self.data[byte:byte + take]
            self.bitpos += take * 8
            self.stored_remaining -= take
        if self.stored_remaining:
            return NEED_INPUT
        self.state = _S_DONE if self.final_block else _S_BLOCK_HEADER
        return None

    def _decode_huff_native(self, lib, finish: bool):
        """Run the block's symbol loop in the compiled host runtime
        (native/zng_host.c zng_decode_huff); grows the output buffer on
        demand and maps return codes to the exact zlib error strings."""
        import ctypes

        lit_np, dist_np = self.lit_lut, self.dist_lut
        out = self.out
        real = len(out)
        bp = ctypes.c_long(self.bitpos)
        ol = ctypes.c_long(real)
        nc = ctypes.c_long(0)
        # initial slack: ~8x the remaining compressed bytes, clamped to a
        # typical block's output (the retry loop doubles on underestimate,
        # ret == 2); a large clamp would memset+truncate MBs per block
        grow = max(1 << 12, min((len(self.data) - (self.bitpos >> 3)) * 8,
                                1 << 17))
        while True:
            out.extend(np.empty(grow, np.uint8).data)
            grow *= 2
            dptr, danchor = self._dptr()
            oanchor = ctypes.c_char.from_buffer(out)
            ret = lib.zng_decode_huff(
                dptr, len(self.data),
                ctypes.byref(bp),
                ctypes.c_void_p(lit_np.ctypes.data),
                ctypes.c_void_p(dist_np.ctypes.data),
                ctypes.c_void_p(ctypes.addressof(oanchor)), len(out),
                ctypes.byref(ol),
                self.window_size, int(finish), ctypes.byref(nc),
                self._lut_bits[0], self._lut_bits[1])
            del danchor, oanchor
            real = ol.value
            if ret != 2:
                break
        del out[real:]
        self.bitpos = bp.value
        self.codes_used += nc.value
        if ret == 0:
            self.state = _S_DONE if self.final_block else _S_BLOCK_HEADER
            return None
        if ret == 1:
            return NEED_INPUT
        msgs = {-2: "invalid literal/length code",
                -3: "invalid distance code",
                -4: "invalid distance too far back",
                -5: "unexpected end of stream"}
        raise InflateError(msgs[ret])

    def _decode_huff(self, finish: bool):
        lib = _native()
        if lib is not None:
            return self._decode_huff_native(lib, finish)
        # Hot loop: all-local packed-list lookups, one LUT entry per symbol
        # (scalar list indexing beats numpy scalar indexing ~10x in CPython).
        if self._lut_list is None:
            self._lut_list = (self.lit_lut.tolist(), self.dist_lut.tolist())
        lit_lut, dist_lut = self._lut_list
        data = self.data
        out = self.out
        bitpos = self.bitpos
        total_bits = len(data) * 8
        wsize = self.window_size
        lb, le, db, de = _LB, _LE, _DB, _DE
        ncodes = 0
        try:
            while True:
                # decode literal/length symbol (per-component rollbacks
                # below handle input exhaustion exactly, like the C loop)
                hold = int.from_bytes(data[bitpos >> 3:(bitpos >> 3) + 7],
                                      "little") >> (bitpos & 7)
                entry = lit_lut[hold & 0x7FFF]
                if entry < 0:
                    if bitpos + 15 > total_bits and not finish:
                        return NEED_INPUT
                    raise InflateError("invalid literal/length code")
                nb = entry & 15
                sym = entry >> 4
                bitpos += nb
                if bitpos > total_bits:
                    if finish:
                        raise InflateError("unexpected end of stream")
                    bitpos -= nb
                    return NEED_INPUT
                ncodes += 1
                if sym < 256:
                    out.append(sym)
                    continue
                if sym == 256:
                    self.state = (_S_DONE if self.final_block
                                  else _S_BLOCK_HEADER)
                    return None
                if sym > 285:
                    raise InflateError("invalid literal/length code")
                hold >>= nb
                used = nb
                # length extra bits
                i = sym - 257
                e = le[i]
                length = lb[i] + (hold & ((1 << e) - 1))
                hold >>= e
                used += e
                bitpos += e
                # distance symbol
                dentry = dist_lut[hold & 0x7FFF]
                if dentry < 0 or (dentry >> 4) > 29:
                    if bitpos + 15 > total_bits and not finish:
                        bitpos -= used
                        ncodes -= 1       # symbol will be re-decoded
                        return NEED_INPUT
                    raise InflateError("invalid distance code")
                dnb = dentry & 15
                dsym = dentry >> 4
                hold >>= dnb
                used += dnb
                bitpos += dnb
                e = de[dsym]
                dist = db[dsym] + (hold & ((1 << e) - 1))
                used += e
                bitpos += e
                if bitpos > total_bits:
                    if finish:
                        raise InflateError("unexpected end of stream")
                    bitpos -= used
                    ncodes -= 1           # symbol will be re-decoded
                    return NEED_INPUT
                if dist > len(out) or dist > wsize:
                    raise InflateError("invalid distance too far back")
                # LZ77 copy (bulk slices, pattern-fill for overlap)
                if dist >= length:
                    start = len(out) - dist
                    out += out[start:start + length]
                else:
                    pattern = out[len(out) - dist:]
                    reps = length // dist + 1
                    out += (pattern * reps)[:length]
                continue
        finally:
            self.bitpos = bitpos
            self.codes_used += ncodes


class _Rollback(Exception):
    pass


# zng_inflate_stream's two-level build overflowed its table caps — cannot
# happen for Kraft-valid code sets, but hostile inputs must degrade to the
# flat path, not crash.
_TBL2_OVERFLOW = "tbl2_overflow"

# zng_inflate_stream return-code -> exact zlib error string
_STREAM_ERRMSG = {
    -1: "too many length or distance symbols",
    -2: "invalid literal/length code",
    -3: "invalid distance code",
    -4: "invalid distance too far back",
    -5: "unexpected end of stream",
    -6: "invalid code lengths set",
    -7: "invalid bit length repeat",
    -8: "invalid code -- missing end-of-block",
    -9: "invalid literal/lengths set",
    -10: "invalid distances set",
    -11: "invalid stored block lengths",
    -12: "invalid block type",
}


_scratch = threading.local()


def _scratch_tabs():
    """Per-thread decode-table scratch (small, reused every call)."""
    lit = getattr(_scratch, "lit", None)
    if lit is None:
        _scratch.lit = np.empty(1 << 13, np.int32)
        _scratch.dist = np.empty(1 << 13, np.int32)
    return _scratch.lit, _scratch.dist


def _scratch_out(need: int) -> np.ndarray:
    """Per-thread output buffer pool for the one-shot native decode,
    reused WHEN SAFE: results are returned as zero-copy memoryviews into
    these buffers, so a buffer is only recycled once no caller still
    holds a view (refcount check — a live view keeps a reference on the
    array). Warm-page reuse matters enormously: a fresh multi-MB np.empty
    is mmap'd cold and the kernel zero-fills every page under the C write
    loop (measured 5x slower end-to-end than warm reuse). Two slots,
    because the canonical `out = decompress(...)` loop still holds the
    previous result at the moment of the next call — ping-ponging keeps
    that pattern on warm buffers; callers retaining 2+ results fall back
    to a cold fresh buffer (correct, just slower once). This is the
    reference's single-arena allocation economics (deflate.c:202-264)
    without the output memcpy."""
    import sys as _sys

    pool = getattr(_scratch, "outs", None)
    if pool is None:
        pool = _scratch.outs = [None, None]
    # refs when free: pool slot + loop variable + getrefcount arg = 3
    for arr in pool:
        if arr is not None and arr.size >= need \
                and _sys.getrefcount(arr) <= 3:
            return arr
    grow = 1 << max(20, int(np.ceil(np.log2(need))))
    for i, arr in enumerate(pool):
        if arr is None or _sys.getrefcount(arr) <= 3:
            pool[i] = np.empty(grow, np.uint8)
            return pool[i]
    return np.empty(grow, np.uint8)      # all slots held by live results


def _scratch_out_replace(old: np.ndarray, new: np.ndarray) -> None:
    """Point the pool slot holding `old` at `new` (grow path)."""
    pool = getattr(_scratch, "outs", None)
    if pool is not None:
        for i, a in enumerate(pool):
            if a is old:
                pool[i] = new
                return


def _inflate_raw_native(lib, data: bytes, wbits: int,
                        dictionary: bytes | None, start: int = 0):
    """One-shot whole-stream decode straight into a numpy buffer (no
    bytearray window bookkeeping — the RawInflater state machine is only
    needed for streaming/resumable callers). `start` skips that many
    framing bytes without slicing the input.

    Returns (out, bits past start) or None to defer to the RawInflater
    path (table overflow). `out` is a zero-copy memoryview over the
    per-thread scratch buffer — no output-sized memcpy (the Python-wrapper
    decode tax); _scratch_out's refcount guard
    keeps a still-referenced result from being overwritten by the next
    call."""
    import ctypes

    wsize = 1 << wbits
    dct = (dictionary or b"")[-wsize:]
    dlen = len(dct)
    payload_len = len(data) - start
    lit, dist = _scratch_tabs()
    out = _scratch_out(max(4096, payload_len * 4 + dlen))
    st = np.zeros(8, np.int64)
    dptr = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p)
    bp = ctypes.c_long(8 * start)
    nc = ctypes.c_long(0)
    if dlen:
        out[:dlen] = np.frombuffer(dct, np.uint8)
    ol = ctypes.c_long(dlen)
    while True:
        ret = lib.zng_inflate_stream(
            dptr, len(data), ctypes.byref(bp),
            ctypes.c_void_p(st.ctypes.data),
            ctypes.c_void_p(lit.ctypes.data), lit.size,
            ctypes.c_void_p(dist.ctypes.data), dist.size,
            ctypes.c_void_p(out.ctypes.data), out.size, ctypes.byref(ol),
            wsize, 1, ctypes.byref(nc), 0)
        if ret != 2:
            break
        bigger = np.empty(out.size * 2, np.uint8)
        bigger[:ol.value] = out[:ol.value]
        _scratch_out_replace(out, bigger)
        out = bigger
    if ret == 0:
        return memoryview(out)[dlen:ol.value], bp.value - 8 * start
    if ret == -13:
        return None
    raise InflateError(_STREAM_ERRMSG[ret])


def inflate_raw(data: bytes, wbits: int = 15, dictionary: bytes | None = None,
                start: int = 0):
    """One-shot raw inflate of data[start:] (offset passed through to the
    native loop so callers never slice multi-MB payloads). Returns
    (output, bits_consumed past start); output is bytes-like — a zero-copy
    memoryview on the native path, bytes on the conformance fallback.
    Callers needing a real bytes object wrap with bytes(out)."""
    lib = _native()
    if lib is not None:
        r = _inflate_raw_native(lib, bytes(data), wbits, dictionary, start)
        if r is not None:
            return r
    inf = RawInflater(wbits=wbits, dictionary=dictionary)
    inf.feed(data[start:] if start else data)
    r = inf.run(finish=True)
    assert r == STREAM_END
    return inf.output(), inf.bitpos
