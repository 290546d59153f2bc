"""Strategy constants, the level table, and the host (numpy) encoder.

`LEVELS` parameterizes one match engine for every level (zlib-ng
configuration_table, deflate.c:142-168), equal to `zlibng_tpu/stream/
deflate.py:LEVELS`. `compress` is the port's copy of that module's host
encoder: levels 0-9, every strategy, zlib/gzip/raw framing, preset
dictionaries and the per-block stored/static/dynamic choice
(zng_tr_flush_block, trees.c:657-692). `compress_cuda` sends level 0 and
inputs under 1024 bytes here, as `compress_tpu` does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..checksum.adler32 import adler32
from ..checksum.crc32 import crc32
from ..errors import StreamError
from ..format import headers as H
from ..format.constants import (
    DIST_EXTRA, FIXED_DIST_CODES_REV, FIXED_DIST_LENGTHS, FIXED_LIT_CODES_REV,
    FIXED_LIT_LENGTHS, LENGTH_EXTRA, MAX_BITS, MAX_MATCH, WINDOW_SIZE,
    dist_to_code, effective_window, length_to_code,
)
from ..huffman.bitpack import pack_bits, token_bits
from ..huffman.encode import build_dynamic_header, huffman_table
from ..lz77.engine import MatchConfig, find_matches, lazy_parse

# strategies (zlib-ng.h.in:199-203)
Z_DEFAULT_STRATEGY = 0
Z_FILTERED = 1
Z_HUFFMAN_ONLY = 2
Z_RLE = 3
Z_FIXED = 4

# data_type values (zlib-ng.h.in:206-209)
Z_BINARY = 0
Z_TEXT = 1
Z_UNKNOWN = 2

# bytes 0..31 that mark a block as binary (trees.c:756-780 black list:
# bits 0..6, 14..25, 28..31; 7/8/11/12/26/27 are tolerated "gray" codes,
# 9/10/13 -- TAB/LF/CR -- are textual)
_BLACKLIST = np.array([(0xF3FFC07F >> i) & 1 for i in range(32)], dtype=bool)

DEFAULT_BLOCK = 1 << 16  # input bytes per deflate block


def detect_data_type(lit_freq: np.ndarray) -> int:
    """TEXT/BINARY heuristic over a block's literal byte frequencies
    (detect_data_type, trees.c:756-780)."""
    if (lit_freq[:32][_BLACKLIST] > 0).any():
        return Z_BINARY
    if lit_freq[9] or lit_freq[10] or lit_freq[13] \
            or (lit_freq[32:256] > 0).any():
        return Z_TEXT
    return Z_BINARY  # empty or gray-listed bytes only


@dataclass(frozen=True)
class LevelConfig:
    chain: int
    lazy: bool
    max_lazy: int
    nice: int
    # good_length analog (deflateTune `good`): after the first 16 probes,
    # positions whose best probe already reaches `good` bytes (capped at
    # the 16-byte probe width) stop improving
    good: int = 12


LEVELS = {
    1: LevelConfig(2, False, 4, 16, good=8),
    2: LevelConfig(4, False, 5, 16, good=8),
    3: LevelConfig(8, False, 6, 32, good=8),
    4: LevelConfig(8, True, 16, 64, good=8),
    5: LevelConfig(16, True, 16, 64, good=10),
    6: LevelConfig(16, True, 32, 128, good=12),
    7: LevelConfig(32, True, 32, 128, good=12),
    8: LevelConfig(48, True, 64, 258, good=12),
    9: LevelConfig(64, True, 258, 258, good=12),
}


def level_config_from(obj) -> LevelConfig:
    """The port's LevelConfig from any object with `chain`, `lazy`,
    `max_lazy`, `nice` and `good` (e.g. a deflateTune setting)."""
    return LevelConfig(int(obj.chain), bool(obj.lazy), int(obj.max_lazy),
                       int(obj.nice), int(obj.good))


def _match_config(level: int) -> MatchConfig:
    lc = LEVELS[max(1, min(9, level))]
    return MatchConfig(chain=lc.chain, lazy=lc.lazy, max_lazy=lc.max_lazy,
                       nice=lc.nice, max_len=MAX_MATCH)


def compress_bound(n: int, wbits: int = 15, level: int | None = None,
                   has_dict: bool = False) -> int:
    """Worst-case compressed size (deflateBound analog, deflate.c:709-781):
    wrapper bytes (zlib 6 [+4 DICTID], gzip 18), then for level 0 stored
    blocks of <= 65535 bytes, for a known level at most 9 bits a literal
    plus per-block header and EOB (the block chooser caps every block at
    min(stored, static)), else the conservative formula."""
    if 0 < wbits <= 15:
        wrap = 6 + (4 if has_dict else 0)
    elif wbits > 15:
        wrap = 18
    else:
        wrap = 0
    blocks = n // DEFAULT_BLOCK + 1
    if level == 0:
        return n + 10 * blocks + 7 + wrap
    if level is not None:
        return n + ((n + 7) >> 3) + 4 * blocks + 10 + wrap
    return n + (n >> 3) + (n >> 6) + 11 * blocks + wrap + 10


# ---------------------------------------------------------------------------
# block tokenization
# ---------------------------------------------------------------------------
def _tokenize_block(vdata: np.ndarray, bstart: int, bend: int,
                    cfg: MatchConfig, strategy: int,
                    window: int = WINDOW_SIZE):
    """Tokens (sel_val, sel_len, sel_dist) int32 for payload [bstart, bend)
    of the virtual stream vdata (dictionary/history before bstart);
    `window` bounds the match distance (MAX_DIST, deflate.h:415)."""
    if strategy == Z_HUFFMAN_ONLY:
        lits = vdata[bstart:bend].astype(np.int32)
        z = np.zeros(lits.shape[0], np.int32)
        return lits, z, z
    if strategy == Z_RLE:
        lane_start = max(0, bstart - 1)  # rle looks 1 byte back only
    else:
        lane_start = max(0, bstart - window)
    lane = vdata[lane_start:bend]
    es, ee = bstart - lane_start, bend - lane_start
    if strategy == Z_RLE:
        best_len, best_dist = _rle_matches(lane, es, ee, cfg)
    else:
        best_len, best_dist = find_matches(lane, es, ee, cfg, window=window)
        if strategy == Z_FILTERED:
            # favor literals: drop short matches (deflate.c Z_FILTERED)
            keep = best_len >= 6
            best_len = np.where(keep, best_len, 0)
            best_dist = np.where(keep, best_dist, 0)
    pos, sel_len, sel_dist = lazy_parse(best_len, best_dist, es, ee, cfg)
    sel_val = lane[pos].astype(np.int32)
    return sel_val, sel_len, sel_dist


def _rle_matches(lane: np.ndarray, es: int, ee: int, cfg: MatchConfig):
    """Distance-1 run matching (deflate_rle.c / compare256_rle)."""
    N = lane.shape[0]
    pos = np.arange(N, dtype=np.int64)
    # r[i] = equal byte pairs from pair (i, i+1), via the distance to the
    # next inequality (reverse running minimum)
    eq = lane[1:] == lane[:-1]
    falses = np.where(~eq, np.arange(eq.size), eq.size)
    next_false = np.minimum.accumulate(falses[::-1])[::-1]
    r = np.zeros(N + 1, dtype=np.int64)
    r[:eq.size] = next_false - np.arange(eq.size)
    # a match at i (dist 1) needs lane[i] == lane[i-1]; then len = 1 + r[i]
    prev_eq = np.concatenate([[False], eq])
    best_len = np.where(prev_eq, 1 + r[:N], 0)
    best_len = np.minimum(np.minimum(best_len, cfg.max_len), ee - pos)
    best_len = np.where((pos >= 1) & (best_len >= 3), best_len, 0)
    best_dist = np.where(best_len > 0, 1, 0)
    return best_len.astype(np.int32), best_dist.astype(np.int32)


# ---------------------------------------------------------------------------
# block emission
# ---------------------------------------------------------------------------
def _extra_weights():
    lext = np.zeros(286, np.int64)
    lext[257:286] = LENGTH_EXTRA[:29]
    return lext, DIST_EXTRA[:30].astype(np.int64)


def _static_cost(lfreq: np.ndarray, dfreq: np.ndarray) -> int:
    lext, dext = _extra_weights()
    return int((lfreq * (FIXED_LIT_LENGTHS[:286] + lext)).sum()
               + (dfreq * (FIXED_DIST_LENGTHS + dext)).sum())


def _dynamic_cost(lfreq, dfreq, llen, dlen, header_bits) -> int:
    lext, dext = _extra_weights()
    return int((lfreq * (llen + lext)).sum() + (dfreq * (dlen + dext)).sum()
               + header_bits)


def _block_freqs(sel_val, sel_len, sel_dist):
    is_match = sel_len > 0
    lsyms = np.where(is_match, length_to_code(np.maximum(sel_len, 3)),
                     sel_val)
    lfreq = np.bincount(lsyms, minlength=286).astype(np.int64)
    lfreq[256] += 1  # EOB
    dsyms = dist_to_code(np.maximum(sel_dist, 1))[is_match]
    dfreq = np.bincount(dsyms, minlength=30).astype(np.int64)
    return lfreq, dfreq


def _emit_block(raw: np.ndarray, sel_val, sel_len, sel_dist, final: bool,
                bitpos_mod8: int, strategy: int, force_stored: bool = False):
    """Choose the block type and emit one block's (values, nbits) arrays.
    Returns (values, nbits, new_bitpos_mod8)."""
    n = raw.shape[0]
    lfreq, dfreq = _block_freqs(sel_val, sel_len, sel_dist)
    static_bits = _static_cost(lfreq, dfreq)
    if strategy == Z_FIXED:
        dyn_bits = None
    else:
        llen, lcode = huffman_table(lfreq, MAX_BITS)
        dlen, dcode = huffman_table(dfreq, MAX_BITS)
        hdr_tokens, hdr_bits = build_dynamic_header(llen, dlen)
        dyn_bits = _dynamic_cost(lfreq, dfreq, llen, dlen, hdr_bits)
    pad = (8 - ((bitpos_mod8 + 3) & 7)) & 7
    stored_bits = 3 + pad + 32 + 8 * n

    choice = "static"
    best = static_bits
    if dyn_bits is not None and dyn_bits < best:
        choice, best = "dynamic", dyn_bits
    # stored LEN is 16-bit: only blocks <= 65535 bytes may be stored
    if force_stored or (n <= 0xFFFF and stored_bits < best + 3):
        choice = "stored"

    if choice == "stored":
        values = np.concatenate([
            np.array([int(final), 0, n, (~n) & 0xFFFF], dtype=np.uint64),
            raw.astype(np.uint64)])
        nbits = np.concatenate([np.array([3, pad, 16, 16], dtype=np.int64),
                                np.full(n, 8, dtype=np.int64)])
    else:
        if choice == "static":
            llen_u, lcode_u = FIXED_LIT_LENGTHS, FIXED_LIT_CODES_REV
            dlen_u, dcode_u = FIXED_DIST_LENGTHS, FIXED_DIST_CODES_REV
            head = [(int(final) | (1 << 1), 3)]
        else:
            llen_u, lcode_u, dlen_u, dcode_u = llen, lcode, dlen, dcode
            head = [(int(final) | (2 << 1), 3)] + hdr_tokens
        tv, tn = token_bits(sel_len, sel_val, sel_dist,
                            llen_u, lcode_u, dlen_u, dcode_u)
        values = np.concatenate([
            np.array([v for v, _ in head], dtype=np.uint64), tv,
            np.array([int(lcode_u[256])], dtype=np.uint64)])
        nbits = np.concatenate([
            np.array([nb for _, nb in head], dtype=np.int64), tn,
            np.array([int(llen_u[256])], dtype=np.int64)])
    new_mod8 = (bitpos_mod8 + int(nbits.sum())) & 7
    return values, nbits, new_mod8


# ---------------------------------------------------------------------------
# one-shot compress
# ---------------------------------------------------------------------------
def compress(data, level: int = 6, wbits: int = 15,
             strategy: int = Z_DEFAULT_STRATEGY,
             dictionary: bytes | None = None,
             block_size: int = DEFAULT_BLOCK) -> bytes:
    """Compress on the host to zlib (wbits 9..15), raw (-9..-15) or gzip
    (+16) format, one deflate block per `block_size` input bytes."""
    if not (-15 <= wbits <= 31):
        raise StreamError("invalid windowBits")
    buf = np.frombuffer(memoryview(bytes(data)), dtype=np.uint8)
    payload = _deflate_payload(buf, level, strategy, dictionary, block_size,
                               window=effective_window(wbits))
    if wbits < 0:
        return payload
    if wbits > 15:
        return (H.build_gzip_header(level=level) + payload
                + H.build_gzip_trailer(crc32(buf), buf.size))
    dictid = adler32(dictionary) if dictionary is not None else None
    head = H.build_zlib_header(wbits=max(wbits, 9), level=level,
                               dictid=dictid)
    return head + payload + H.build_zlib_trailer(adler32(buf))


def _deflate_payload(buf: np.ndarray, level: int, strategy: int,
                     dictionary: bytes | None, block_size: int,
                     window: int = WINDOW_SIZE) -> bytes:
    n = buf.size
    if dictionary:
        d = np.frombuffer(memoryview(bytes(dictionary)), dtype=np.uint8)
        d = d[-window:]
        vdata = np.concatenate([d, buf])
        base = d.size
    else:
        vdata = buf
        base = 0

    cfg = _match_config(level)
    all_vals, all_nbits = [], []
    mod8 = 0
    if level == 0:
        block_size = min(block_size, 0xFFFF)  # stored LEN is 16-bit
    if n == 0:
        blocks = [(base, base)]
    else:
        blocks = [(base + s, base + min(s + block_size, n))
                  for s in range(0, n, block_size)]
    for bi, (bs, be) in enumerate(blocks):
        final = bi == len(blocks) - 1
        raw = vdata[bs:be]
        if level == 0:
            z = np.zeros(0, np.int32)
            v, nb, mod8 = _emit_block(raw, z, z, z, final, mod8, strategy,
                                      force_stored=True)
        else:
            sv, sl, sd = _tokenize_block(vdata, bs, be, cfg, strategy,
                                         window=window)
            v, nb, mod8 = _emit_block(raw, sv, sl, sd, final, mod8, strategy)
        all_vals.append(v)
        all_nbits.append(nb)
    out, _bits = pack_bits(np.concatenate(all_vals),
                           np.concatenate(all_nbits))
    return out.tobytes()
