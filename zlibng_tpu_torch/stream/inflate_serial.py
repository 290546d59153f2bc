"""Serial (host) DEFLATE decoder: the format-exact conformance path.

The numpy path of `zlibng_tpu/stream/inflate_serial.py` (zlib-ng
inflate.c:476-1201, inftrees.c, inffast_tpl.h): all three block types,
dynamic table construction with the exact error acceptance rules, distance
validation, preset dictionaries, resumable state over fed input. Decoding
goes block at a time over a flat 15-bit LUT (one lookup per symbol);
stored blocks and LZ77 copies are bulk slices. The device decoder
(ops/inflate.py) parses block headers with it and reruns a stream here when
it needs zlib's exact error text.

Error message strings match zlib's exactly.
"""
from __future__ import annotations

import numpy as np

from ..errors import DataError as InflateError  # Z_DATA_ERROR; .msg is zlib's
from ..format.constants import (
    BL_ORDER, DIST_BASE, DIST_EXTRA, FIXED_LIT_LENGTHS, LENGTH_BASE,
    LENGTH_EXTRA,
)
from ..huffman.decode_tables import (
    CODES, DISTS, LENS, InvalidCodeError, build_decode_lut, build_packed_lut,
)

# Decoder progress results
NEED_INPUT = "need_input"
STREAM_END = "stream_end"

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

# Fixed tables, built once. The fixed distance tree is defined over 32
# five-bit codes (RFC 1951 §3.2.6); symbols 30/31 are rejected at decode.
_FIXED_LIT_LUT = build_packed_lut(FIXED_LIT_LENGTHS, LENS, max_len=15)
_FIXED_DIST_LUT = build_packed_lut(np.full(32, 5, dtype=np.int32), DISTS,
                                   max_len=15)
_FIXED_LUT_LIST = (_FIXED_LIT_LUT.tolist(), _FIXED_DIST_LUT.tolist())

# zlib's error strings by the C host runtime's return codes (the
# reference's zng_inflate_stream)
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


class _Rollback(Exception):
    pass


class RawInflater:
    """Raw DEFLATE decoder over an append-only input buffer.

    feed() bytes, then run(finish=...) until STREAM_END. Decoded output
    accumulates in .out (bytearray); .bitpos tracks consumed input bits.
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
        self.dist_lut = None
        self._last_lengths = None  # (lengths, hlit, hdist) of last dyn block
        self._lut_list = None      # list LUTs for the Python loop

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
        # one-shot fast path: adopt the caller's bytes object; converted to
        # a bytearray on the first append
        if not self.data and type(chunk) is bytes:
            self.data = chunk
        elif type(self.data) is bytes:
            self.data = bytearray(self.data)
            self.data += chunk
        else:
            self.data += chunk

    def output(self) -> bytes:
        """Decoded bytes (excluding any preset dictionary prefix)."""
        if self.dict_len == 0:
            return bytes(self.out)
        return bytes(memoryview(self.out)[self.dict_len:])

    # -- main loop ----------------------------------------------------------
    def run(self, finish: bool = False) -> str:
        """Decode until out of input (NEED_INPUT) or final block done
        (STREAM_END). Raises InflateError on corrupt data; if `finish` and
        input is exhausted mid-stream, raises InflateError('unexpected end')."""
        while True:
            if self.state == _S_DONE:
                return STREAM_END
            if self.state == _S_BLOCK_HEADER:
                r = self._read_block_header(finish)
            elif self.state == _S_STORED:
                r = self._copy_stored(finish)
            else:
                r = self._decode_huff(finish)
            if r is NEED_INPUT:
                if finish:
                    raise InflateError("unexpected end of stream")
                return NEED_INPUT

    def _read_block_header(self, finish: bool):
        if self._bits_avail() < 3:
            return NEED_INPUT
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
            self.lit_lut = _FIXED_LIT_LUT
            self.dist_lut = _FIXED_DIST_LUT
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
        # Conservative availability bound: roll back and retry whenever bits
        # run out mid-parse.
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
            self._last_lengths = (lengths, hlit, hdist)
            return None
        except _Rollback:
            self.bitpos = save
            return NEED_INPUT

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

    def _decode_huff(self, finish: bool):
        # Hot loop: all-local packed-list lookups, one LUT entry per symbol.
        if self._lut_list is None:
            self._lut_list = (self.lit_lut.tolist(), self.dist_lut.tolist())
        lit_lut, dist_lut = self._lut_list
        data = self.data
        out = self.out
        bitpos = self.bitpos
        total_bits = len(data) * 8
        wsize = self.window_size
        lb, le, db, de = _LB, _LE, _DB, _DE
        try:
            while True:
                # literal/length symbol (per-component rollbacks below
                # handle input exhaustion exactly, like the C loop)
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
        finally:
            self.bitpos = bitpos


def inflate_raw(data: bytes, wbits: int = 15, dictionary: bytes | None = None,
                start: int = 0):
    """One-shot raw inflate of data[start:]. Returns (output bytes,
    bits consumed past start)."""
    inf = RawInflater(wbits=wbits, dictionary=dictionary)
    inf.feed(data[start:] if start else data)
    r = inf.run(finish=True)
    assert r == STREAM_END
    return inf.output(), inf.bitpos
