"""Stateful streaming API: the zlib-ng stream surface, a copy of
`zlibng_tpu/stream/api.py` on the port's host engine.

Deflate  <-> zng_deflateInit2/deflate/deflateEnd and the advanced entry
             points (SetDictionary/GetDictionary/Copy/Reset/Params/Tune/
             Bound/Pending/Prime/SetHeader, flush modes; deflate.c:283-1500)
Inflate  <-> zng_inflateInit2/inflate and SetDictionary/GetDictionary/Sync/
             Copy/Reset/Reset2/Prime/Mark/GetHeader/SyncPoint/CodesUsed
             (inflate.c:104-1460)

Semantics:
  * Deflate buffers input per block; NO_FLUSH compresses once a full block
    (64 KiB) accumulates, keeping a 32 KiB history window across blocks.
  * SYNC/FULL/PARTIAL flush byte-align as zlib-ng does (an empty stored
    block or an empty static block, deflate.c:1061-1083); FULL also clears
    the history (CLEAR_HASH).
  * All state (window, bit tail, checksum) is plain data: copy() is a deep
    copy (deflateCopy).
Both run on the host, as in the reference: Deflate on the numpy engine of
`stream/deflate.py`, Inflate on the serial decoder (C route first).
"""
from __future__ import annotations

import copy as _copy

import numpy as np

from ..checksum.adler32 import adler32
from ..checksum.crc32 import crc32
from ..errors import DataError, NeedDictError, StreamError
from ..format import headers as H
from ..format.constants import WINDOW_SIZE, effective_window
from ..huffman.bitpack import pack_bits
from ..lz77.engine import MatchConfig
from ..stream import deflate as D
from ..stream.inflate_serial import (
    BLOCK_BOUNDARY as _RAW_BOUNDARY, RawInflater,
    STREAM_END as _RAW_END, TREES_DONE as _RAW_TREES,
)

# flush constants (zlib-ng.h.in:171-177)
Z_NO_FLUSH = 0
Z_PARTIAL_FLUSH = 1
Z_SYNC_FLUSH = 2
Z_FULL_FLUSH = 3
Z_FINISH = 4
Z_BLOCK = 5
Z_TREES = 6

_FIXED_EOB_BITS = (0, 7)  # static EOB: 7 zero bits


class Deflate:
    """Streaming compressor (zng_stream deflate side)."""

    def __init__(self, level: int = 6, method: int = 8, wbits: int = 15,
                 mem_level: int = 8, strategy: int = D.Z_DEFAULT_STRATEGY,
                 dictionary: bytes | None = None):
        if method != 8 or not (-15 <= wbits <= 31) or abs(wbits) < 8 and wbits != 0:
            raise StreamError("invalid parameters")
        if not (0 <= level <= 9) and level != -1:
            raise StreamError("invalid compression level")
        self.level = 6 if level == -1 else level
        self.wbits = wbits
        # declared-window match-distance bound (MAX_DIST analog,
        # deflate.h:415): matches never reach past the window a conforming
        # decoder of this stream will allocate
        self._max_dist = effective_window(wbits)
        self.mem_level = mem_level
        self.strategy = strategy
        self.block_size = min(1 << (mem_level + 12), D.DEFAULT_BLOCK)
        self.raw = wbits < 0
        self.gzip = wbits > 15
        self.total_in = 0
        self.total_out = 0
        self.adler = 0 if self.gzip else 1
        self.gzip_header: H.GzipHeader | None = None
        self._header_written = False
        self._finished = False
        self._window = b""           # last ≤32K of consumed input
        self._inbuf = bytearray()    # not yet compressed
        self._out = bytearray()      # compressed, ready to hand out
        self._bit_hold = 0           # pending sub-byte bits (LSB-first)
        self._bit_count = 0
        self._dict = None
        self._tune = None            # deflateTune per-stream override
        self.data_type = D.Z_UNKNOWN  # strm->data_type (set on first block)
        if dictionary is not None:
            self.set_dictionary(dictionary)

    # -- dictionary ------------------------------------------------------
    def set_dictionary(self, dictionary: bytes) -> None:
        """deflateSetDictionary (deflate.c:456-512): seeds the window; in
        zlib mode DICTID is emitted in the header."""
        if self._header_written or self.total_in:
            raise StreamError("dictionary must be set before compression")
        if self.gzip:
            raise StreamError("cannot set dictionary in gzip mode")
        d = bytes(dictionary)
        # DICTID covers the FULL dictionary (deflate.c:456-512 computes the
        # adler before trimming to w_size); only the window keeps ≤ max_dist
        self._dict_id = adler32(d)
        self._dict = d[-self._max_dist:]
        self._window = self._dict
        # note: the stream checksum covers only the payload; the dictionary
        # id (adler of the dict) goes in the header, not the trailer

    def get_dictionary(self) -> bytes:
        """deflateGetDictionary: current window contents."""
        return bytes(self._window)

    # -- parameters ------------------------------------------------------
    def params(self, level: int, strategy: int | None = None) -> None:
        """deflateParams: takes effect at the next block boundary."""
        self._compress_buffered(final=False, force=True)
        self.level = level
        if strategy is not None:
            self.strategy = strategy

    def tune(self, good: int, lazy: int, nice: int, chain: int) -> None:
        """deflateTune (deflate.c:679-690): expert match-engine knobs, a
        per-stream override (the reference keeps them in deflate_state).
        On the device pipeline (compress_cuda(tune=...)) `good` is the
        probe-escalation threshold; this host engine evaluates its whole
        candidate budget, so `good` does not change its output."""
        lc = D.LEVELS[max(1, min(9, self.level))]
        self._tune = D.LevelConfig(chain=chain, lazy=lc.lazy, max_lazy=lazy,
                                   nice=nice, good=good)

    def set_header(self, header: H.GzipHeader) -> None:
        """deflateSetHeader: custom gzip header fields."""
        if not self.gzip:
            raise StreamError("not a gzip stream")
        if self._header_written:
            raise StreamError("header already written")
        self.gzip_header = header

    def bound(self, n: int) -> int:
        """deflateBound (tight: level and dictionary state are known)."""
        return D.compress_bound(n, self.wbits, level=self.level,
                                has_dict=self._dict is not None)

    def pending(self):
        """deflatePending: (pending bytes, pending bits)."""
        return len(self._out), self._bit_count

    def prime(self, bits: int, value: int) -> None:
        """deflatePrime (deflate.c:600-633): inject bits below the next
        emitted data (bit-level stream stitching)."""
        if bits < 0 or bits > 16:
            raise StreamError("invalid prime bits")
        self._emit_bits(value & ((1 << bits) - 1), bits)

    # -- core ------------------------------------------------------------
    def compress(self, data: bytes = b"", flush: int = Z_NO_FLUSH) -> bytes:
        if self._finished:
            if data:
                raise StreamError("compress after finish")
            return self._drain()
        data = bytes(data)
        self.total_in += len(data)
        if self.gzip:
            self.adler = crc32(data, self.adler) if data else self.adler
        elif not self.raw:
            self.adler = adler32(data, self.adler) if data else self.adler
        self._inbuf += data

        if not self._header_written:
            self._write_header()

        if flush == Z_NO_FLUSH:
            # eagerly compress all complete blocks
            while len(self._inbuf) >= self.block_size:
                self._compress_one_block(final=False)
        elif flush in (Z_PARTIAL_FLUSH, Z_SYNC_FLUSH, Z_FULL_FLUSH, Z_BLOCK,
                       Z_TREES):
            self._compress_buffered(final=False, force=True)
            if flush == Z_PARTIAL_FLUSH:
                # empty static block (zng_tr_align, trees.c:615)
                self._emit_bits(0b010, 3)       # BFINAL=0, BTYPE=01
                self._emit_bits(*_FIXED_EOB_BITS)
            elif flush in (Z_SYNC_FLUSH, Z_FULL_FLUSH):
                self._emit_sync_marker()
                if flush == Z_FULL_FLUSH:
                    self._window = b""          # CLEAR_HASH analog
        elif flush == Z_FINISH:
            self._compress_buffered(final=True, force=True)
            self._write_trailer()
            self._finished = True
        else:
            raise StreamError("invalid flush value")
        return self._drain()

    def flush(self, mode: int = Z_FINISH) -> bytes:
        return self.compress(b"", mode)

    def copy(self) -> "Deflate":
        """deflateCopy: full state duplication."""
        return _copy.deepcopy(self)

    def reset(self) -> None:
        """deflateReset: reuse the stream for new data."""
        self.__init__(self.level, 8, self.wbits, self.mem_level, self.strategy)

    # -- internals -------------------------------------------------------
    def _write_header(self) -> None:
        if self.gzip:
            self._out += H.build_gzip_header(self.gzip_header, level=self.level)
        elif not self.raw:
            dictid = self._dict_id if self._dict is not None else None
            self._out += H.build_zlib_header(
                wbits=max(self.wbits, 9), level=self.level, dictid=dictid)
        self._header_written = True

    def _emit_bits(self, value: int, nbits: int) -> None:
        self._bit_hold |= value << self._bit_count
        self._bit_count += nbits
        while self._bit_count >= 8:
            self._out.append(self._bit_hold & 0xFF)
            self._bit_hold >>= 8
            self._bit_count -= 8

    def _emit_align(self) -> None:
        if self._bit_count:
            self._out.append(self._bit_hold & 0xFF)
            self._bit_hold = 0
            self._bit_count = 0

    def _emit_sync_marker(self) -> None:
        """Empty stored block: 00 00 FF FF after alignment (Z_SYNC_FLUSH)."""
        self._emit_bits(0b000, 3)
        self._emit_align()
        self._out += b"\x00\x00\xff\xff"

    def _compress_one_block(self, final: bool) -> None:
        take = self.block_size if not final else len(self._inbuf)
        take = min(take, len(self._inbuf))
        payload = bytes(self._inbuf[:take])
        del self._inbuf[:take]
        self._encode_block(payload, final)
        self._window = (self._window + payload)[-self._max_dist:]

    def _compress_buffered(self, final: bool, force: bool) -> None:
        while len(self._inbuf) >= self.block_size:
            self._compress_one_block(final=False)
        if self._inbuf or final:
            self._compress_one_block(final=final)

    def _encode_block(self, payload: bytes, final: bool) -> None:
        """Encode one block with the array engine, window as history."""
        if self.level == 0:
            self._emit_stored(payload, final)
            return
        vdata = np.frombuffer(self._window + payload, np.uint8)
        bs = len(self._window)
        be = len(vdata)
        if self._tune is not None:
            t = self._tune
            cfg = MatchConfig(chain=t.chain, lazy=t.lazy,
                              max_lazy=t.max_lazy, nice=t.nice)
        else:
            cfg = D._match_config(self.level)
        if len(payload) == 0:
            sv = np.zeros(0, np.int32)
            sl = sv
            sd = sv
        else:
            sv, sl, sd = D._tokenize_block(vdata, bs, be, cfg, self.strategy,
                                           window=self._max_dist)
        if self.data_type == D.Z_UNKNOWN and sv.size:
            # TEXT/BINARY from the first block's literal tallies, once,
            # level>0 only — exactly when zng_tr_flush_block does
            lits = sv[sl == 0]
            self.data_type = D.detect_data_type(
                np.bincount(lits, minlength=256))
        raw = vdata[bs:be]
        values, nbits, _ = D._emit_block(
            raw, sv, sl, sd, final, (self.total_out_bits_mod8()), self.strategy)
        by, total_bits = pack_bits(values, nbits)
        # splice into our bit tail
        self._append_bitstream(by, total_bits)

    def total_out_bits_mod8(self) -> int:
        return self._bit_count

    def _append_bitstream(self, by: np.ndarray, total_bits: int) -> None:
        r = self._bit_count
        if r == 0:
            nb = (total_bits + 7) >> 3
            self._out += by[:nb].tobytes()
            self._bit_count = total_bits & 7
            if self._bit_count:
                self._bit_hold = self._out[-1]
                del self._out[-1:]
        else:
            part = by.astype(np.uint16)
            nb = (total_bits + 7) >> 3
            part = part[:nb]
            sh = np.zeros(nb + 1, np.uint16)
            sh[:nb] |= (part << r) & 0xFF
            sh[1:] |= part >> (8 - r)
            total = r + total_bits
            full = total >> 3
            tail_bits = total & 7
            stream = bytearray([self._bit_hold | int(sh[0])])
            stream += sh[1:].astype(np.uint8).tobytes()
            self._out += stream[:full]
            self._bit_hold = stream[full] if tail_bits else 0
            self._bit_count = tail_bits

    def _emit_stored(self, payload: bytes, final: bool) -> None:
        pos = 0
        n = len(payload)
        while True:
            take = min(n - pos, 0xFFFF)
            last = final and (pos + take == n)
            self._emit_bits(int(last), 1)
            self._emit_bits(0, 2)
            self._emit_align()
            self._out += int(take).to_bytes(2, "little")
            self._out += int(~take & 0xFFFF).to_bytes(2, "little")
            self._out += payload[pos:pos + take]
            pos += take
            if pos >= n:
                break

    def _write_trailer(self) -> None:
        self._emit_align()
        if self.gzip:
            self._out += H.build_gzip_trailer(self.adler, self.total_in)
        elif not self.raw:
            self._out += H.build_zlib_trailer(self.adler)

    def _drain(self) -> bytes:
        out = bytes(self._out)
        del self._out[:]
        self.total_out += len(out)
        return out


class Inflate:
    """Streaming decompressor (zng_stream inflate side)."""

    def __init__(self, wbits: int = 15, dictionary: bytes | None = None):
        if not (-15 <= wbits <= 47):
            raise StreamError("invalid windowBits")
        self.wbits = wbits
        self.total_in = 0
        self.total_out = 0
        self.adler = 1
        self.gzip_header: H.GzipHeader | None = None
        self._mode = None            # 'raw' | 'zlib' | 'gzip' (None: detect)
        self._hdr = bytearray()
        self._raw: RawInflater | None = None
        self._out_consumed = 0
        self._dict = bytes(dictionary) if dictionary is not None else None
        self._need_dict = False
        self._dictid = None
        self._finished = False
        self._trailer = bytearray()
        self._validate = True
        self.data_type = 0           # strm->data_type (inflate.c:1191)
        # sub-byte carry from inflatePrime with bits % 8 != 0: the last
        # _lead_n bits of the logical stream, not yet in _raw.data
        self._lead_n = 0
        self._lead_val = 0
        # bit position where already-primed bits end (consecutive primes
        # stack upward, like the reference's hold |= value << bits)
        self._primed_until = 0
        self._setup_mode()

    def _setup_mode(self):
        w = self.wbits
        if w < 0:
            self._mode = "raw"
            self._raw = RawInflater(wbits=-w, dictionary=self._dict)
        elif w >= 32:
            self._mode = None   # auto-detect zlib vs gzip
        elif w > 15:
            self._mode = "gzip"
        else:
            self._mode = "zlib"

    # -- api -------------------------------------------------------------
    def set_dictionary(self, dictionary: bytes) -> None:
        """inflateSetDictionary (inflate.c analog)."""
        if self._mode == "zlib" and self._dictid is not None:
            if adler32(dictionary) != self._dictid:
                raise DataError("incorrect dictionary")
        if self._raw is not None and self._raw.out and not self._need_dict:
            raise StreamError("dictionary set mid-stream")
        self._dict = bytes(dictionary)
        # buffered header+payload bytes are replayed on the next decompress
        self._need_dict = False

    def get_dictionary(self) -> bytes:
        if self._raw is None:
            return b""
        return bytes(self._raw.out[-WINDOW_SIZE:])

    def decompress(self, data: bytes = b"", finish: bool = False,
                   flush: int = Z_NO_FLUSH) -> bytes:
        """One inflate() call. flush supports Z_NO_FLUSH/Z_FINISH plus the
        block-introspection modes (inflate.c:402-520 doc):

        * Z_BLOCK — stop when the next block boundary is reached during
          this call (after an end-of-block code's output is delivered, or
          right after the wrapper header). data_type is set to unused bits
          + 64 if decoding the last block + 128 if at a block boundary.
        * Z_TREES — like Z_BLOCK, but also stop right after each block
          header (before block data), adding 256 to data_type.
        """
        finish = finish or flush == Z_FINISH
        stop = {Z_BLOCK: "block", Z_TREES: "trees"}.get(flush)
        if self._finished:
            return b""
        self.total_in += len(data)
        buf = data
        header_parsed_now = False

        # header phase
        if self._raw is None:
            self._hdr += buf
            buf = b""
            if self._mode is None:
                if len(self._hdr) >= 2:
                    from ..format.constants import GZIP_MAGIC
                    self._mode = "gzip" if bytes(self._hdr[:2]) == GZIP_MAGIC \
                        else "zlib"
                else:
                    return b""
            try:
                if self._mode == "gzip":
                    self.gzip_header, pos = H.parse_gzip_header(bytes(self._hdr))
                    self.adler = 0
                else:
                    hw, has_dict, dictid, pos = H.parse_zlib_header(bytes(self._hdr))
                    self._dictid = dictid
                    req = self.wbits & 15
                    if req and hw > req:
                        # stream declares a bigger window than requested
                        # (inflate.c:638-644)
                        raise DataError("invalid window size")
                    if has_dict:
                        if self._dict is None:
                            self._need_dict = True
                            raise NeedDictError(dictid)
                        if adler32(self._dict) != dictid:
                            raise DataError("incorrect dictionary")
            except H.NeedMoreInput:
                return b""
            rest = bytes(self._hdr[pos:])
            self._hdr = bytearray()
            # strict distance checking against the stream's own declared
            # window (inflate.c:904-911 INFLATE_STRICT dmax = 1 << len);
            # gzip members have no declared size → requested (or 32K)
            if self._mode == "zlib":
                win = max(hw, 8)
            else:
                win = (self.wbits & 15) or 15
            self._raw = RawInflater(
                wbits=win, dictionary=self._dict if self._mode == "zlib" else None)
            buf = rest + buf
            header_parsed_now = True

        if self._lead_n and (buf or finish):
            # splice new input after the sub-byte inflatePrime carry
            big = (int.from_bytes(buf, "little") << self._lead_n) \
                | self._lead_val
            nbits = len(buf) * 8 + self._lead_n
            if finish:  # flush: zero-pad the final partial byte
                buf = big.to_bytes((nbits + 7) // 8, "little")
                self._lead_n = self._lead_val = 0
            else:
                whole = nbits // 8 * 8
                buf = (big & ((1 << whole) - 1)).to_bytes(whole // 8,
                                                          "little")
                self._lead_n = nbits - whole
                self._lead_val = big >> whole

        before = len(self._raw.out)
        self._raw.feed(buf)
        if header_parsed_now and stop is not None:
            # stop "just before the first byte of the deflate stream":
            # boundary bit set, byte-aligned, nothing decoded yet
            self.data_type = 128
            return b""
        # finish also unblocks the decoder's 48-bit lookahead margin when the
        # only bytes left are the wrapper trailer
        r = self._raw.run(finish=finish, stop=stop)
        new = self._raw.out[before:] if before else self._raw.out[self._raw.dict_len:]
        chunk = bytes(new)
        self.total_out += len(chunk)
        if self._mode == "gzip":
            self.adler = crc32(chunk, self.adler)
        else:
            self.adler = adler32(chunk, self.adler)

        self._set_data_type(r)
        if r == _RAW_END:
            self._check_trailer(finish)
        return chunk

    def _set_data_type(self, r) -> None:
        """strm->data_type after every inflate() return (inflate.c:1191):
        unused input bits + 64 (in last block) + 128 (at block boundary) +
        256 (just after a block header). At a boundary/trees stop the
        unused count is sub-byte; otherwise it is the still-buffered bit
        count, capped at 63 to keep the flag bits unambiguous (the
        reference's 32-bit hold caps it naturally)."""
        raw = self._raw
        if r in (_RAW_BOUNDARY, _RAW_TREES, _RAW_END):
            bits = (-raw.bitpos) & 7
        else:
            bits = min(63, max(0, len(raw.data) * 8 - raw.bitpos))
        self.data_type = (bits + (64 if raw.final_block else 0)
                          + (128 if r == _RAW_BOUNDARY else 0)
                          + (256 if r == _RAW_TREES else 0))

    def _check_trailer(self, finish: bool) -> None:
        # remaining bytes after the deflate payload (all input stays in the
        # raw buffer, so this is idempotent across calls)
        consumed = (self._raw.bitpos + 7) // 8
        rest = bytes(self._raw.data[consumed:])
        need = 8 if self._mode == "gzip" else (4 if self._mode == "zlib" else 0)
        if self._mode == "raw":
            self.unused_data = rest
            self._finished = True
            return
        if len(rest) < need:
            if finish:
                raise DataError("unexpected end of stream")
            return
        t = rest[:need]
        self.unused_data = rest[need:]
        if not self._validate:
            self._finished = True
            return
        if self._mode == "gzip":
            import struct
            crc_exp, isize = struct.unpack("<II", t)
            if crc_exp != self.adler:
                raise DataError("incorrect data check")
            if isize != (self.total_out & 0xFFFFFFFF):
                raise DataError("incorrect length check")
        else:
            import struct
            if struct.unpack(">I", t)[0] != self.adler:
                raise DataError("incorrect data check")
        self._finished = True

    @property
    def eof(self) -> bool:
        return self._finished

    def sync(self) -> bool:
        """inflateSync (inflate.c:1308-1366): scan for the 00 00 FF FF
        full-flush marker and resume decoding after it."""
        if self._raw is None:
            return False
        data = bytes(self._raw.data)
        start = self._raw.bitpos >> 3
        i = data.find(b"\x00\x00\xff\xff", start)
        if i < 0:
            return False
        nr = RawInflater(wbits=15)
        nr.feed(data[i + 4:])
        nr.out = self._raw.out  # history continues
        nr.dict_len = self._raw.dict_len
        self._raw = nr
        return True

    def sync_point(self) -> bool:
        """inflateSyncPoint: at a block boundary with byte alignment?"""
        return self._raw is not None and self._raw.state == 0 \
            and self._raw.bitpos % 8 == 0

    def mark(self) -> tuple[int, int]:
        """inflateMark: (bits into current byte, bytes of output)."""
        if self._raw is None:
            return (0, 0)
        return (self._raw.bitpos & 7, len(self._raw.out) - self._raw.dict_len)

    def codes_used(self) -> int:
        return 0 if self._raw is None else self._raw.codes_used

    def get_header(self) -> H.GzipHeader | None:
        """inflateGetHeader."""
        return self.gzip_header

    def copy(self) -> "Inflate":
        return _copy.deepcopy(self)

    def reset(self, wbits: int | None = None) -> None:
        """inflateReset / inflateReset2."""
        w = self.wbits if wbits is None else wbits
        self.__init__(w, self._dict)

    def validate(self, check: bool) -> None:
        """inflateValidate (inflate.c:1430 analog): toggle wrapper checksum
        verification (used by gzread when the trailer was consumed
        separately)."""
        self._validate = bool(check)

    def undermine(self, subvert: bool) -> None:
        """inflateUndermine: the reference only honors this when built with
        INFLATE_ALLOW_INVALID_DISTANCE; this implementation always validates
        distances, matching the default build (returns unsupported)."""
        raise StreamError("invalid distance checking cannot be disabled")

    def prime(self, bits: int, value: int) -> None:
        """inflatePrime: push bits into the input bit buffer."""
        if self._raw is None:
            raise StreamError("prime before header")
        if bits < 0:  # reference: negative count empties the bit buffer
            self._raw.bitpos = (self._raw.bitpos + 7) & ~7
            self._lead_n = self._lead_val = 0
            self._primed_until = 0
            return
        if bits > 16:
            raise StreamError("invalid prime bits")
        # Reference semantics (inflate.c:277-302): the primed bits are
        # consumed BEFORE any not-yet-read input bits, without re-aligning
        # that input. The RawInflater reads from a contiguous buffer, so
        # prepending k bits shifts the unread tail left by k; a sub-byte
        # remainder is carried in _lead_* and merged with future input.
        byte0 = self._raw.bitpos >> 3
        bit_off = self._raw.bitpos & 7
        tail = bytes(self._raw.data[byte0:])
        big = int.from_bytes(tail, "little") >> bit_off  # unread bits
        nbits = len(tail) * 8 - bit_off
        big |= self._lead_val << nbits
        nbits += self._lead_n
        # insert ABOVE any still-unconsumed previously-primed bits
        off = max(0, self._primed_until - self._raw.bitpos)
        low = big & ((1 << off) - 1)
        big = (((big >> off) << bits) | (value & ((1 << bits) - 1))) << off \
            | low
        nbits += bits
        self._primed_until = self._raw.bitpos + off + bits
        whole = nbits // 8 * 8
        if type(self._raw.data) is bytes:  # zero-copy one-shot buffer
            self._raw.data = bytearray(self._raw.data)
        del self._raw.data[byte0:]
        self._raw.data += (big & ((1 << whole) - 1)).to_bytes(whole // 8,
                                                              "little")
        self._lead_n = nbits - whole
        self._lead_val = big >> whole
        self._raw.bitpos = byte0 * 8
