"""DEFLATE / zlib / gzip format constants and generated tables.

The port's own copy of the tables the compression path reads, generated
from the RFC 1951/1952 rules exactly as `zlibng_tpu/format/constants.py`
generates them (the tests hold each table equal to that module's).
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Basic symbols / limits (RFC 1951)
# ---------------------------------------------------------------------------
MIN_MATCH = 3
MAX_MATCH = 258
MAX_BITS = 15               # max Huffman code length
MAX_BL_BITS = 7             # max code length for the bit-length tree
MAX_WBITS = 15
WINDOW_SIZE = 1 << MAX_WBITS  # 32768


def effective_window(wbits: int) -> int:
    """Match-distance bound implied by the declared windowBits.

    Mirrors zlib-ng's windowBits normalization (deflate.c:306-316):
    negative = raw, +16 = gzip, and windowBits 8 is re-declared as 9. The
    encoder must never emit a match farther back than this.
    """
    w = wbits - 16 if wbits > 15 else abs(wbits)
    if w < 8:
        w = 15  # undeclared window (gzip framing has none; wbits 0 = default)
    elif w == 8:
        w = 9
    return 1 << w


# Order in which code lengths for the code-length alphabet are transmitted
# (RFC 1951 §3.2.7)
BL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# Repeat codes in the code-length alphabet
REP_3_6 = 16    # repeat previous length 3-6 times   (2 extra bits)
REPZ_3_10 = 17  # repeat zero length 3-10 times      (3 extra bits)
REPZ_11_138 = 18  # repeat zero length 11-138 times  (7 extra bits)

# Checksum parameters
ADLER_BASE = 65521
# Largest n such that 255*n*(n+1)/2 + (n+1)*(ADLER_BASE-1) <= 2^32-1
ADLER_NMAX = 5552
CRC_POLY = 0xEDB88320  # reflected CRC-32 polynomial (RFC 1952)

# zlib / gzip framing
ZLIB_METHOD_DEFLATE = 8
GZIP_MAGIC = b"\x1f\x8b"
GZIP_OS_UNIX = 3
# gzip FLG bits (RFC 1952)
GZ_FTEXT, GZ_FHCRC, GZ_FEXTRA, GZ_FNAME, GZ_FCOMMENT = 1, 2, 4, 8, 16


# ---------------------------------------------------------------------------
# Length / distance code tables (generated)
# ---------------------------------------------------------------------------
def _gen_length_tables():
    """Length codes 257..285: (extra_bits, base_length) per RFC 1951 §3.2.5."""
    extra = [0] * 8 + [e for e in (1, 2, 3, 4, 5) for _ in range(4)] + [0]
    base = np.zeros(29, dtype=np.int32)
    length = 3
    for i in range(28):
        base[i] = length
        length += 1 << extra[i]
    base[28] = 258  # code 285 is the single length 258
    return np.array(extra, dtype=np.int32), base


LENGTH_EXTRA, LENGTH_BASE = _gen_length_tables()  # index = code - 257


def _gen_dist_tables():
    """Distance codes 0..29: (extra_bits, base_dist)."""
    extra = [0, 0, 0, 0] + [e for e in range(1, 14) for _ in range(2)]
    base = np.zeros(30, dtype=np.int32)
    dist = 1
    for i in range(30):
        base[i] = dist
        dist += 1 << extra[i]
    return np.array(extra, dtype=np.int32), base


DIST_EXTRA, DIST_BASE = _gen_dist_tables()


def _gen_length_code_lut():
    """length (3..258) -> length code (257..285), as a 256-entry LUT on len-3."""
    lut = np.zeros(256, dtype=np.int32)
    for code in range(28):
        lo = LENGTH_BASE[code]
        hi = lo + (1 << LENGTH_EXTRA[code])
        lut[lo - 3: hi - 3] = 257 + code
    lut[258 - 3] = 285
    return lut


LENGTH_CODE_LUT = _gen_length_code_lut()


def _gen_dist_code_lut():
    """Two-part LUT mapping distance -> dist code (zlib-ng trees.h d_code):
    d <= 256 -> DIST_CODE_LUT[d - 1], d > 256 -> DIST_CODE_LUT[256 +
    ((d - 1) >> 7)]."""
    lut = np.zeros(512, dtype=np.int32)
    for code in range(30):
        lo = DIST_BASE[code]
        hi = lo + (1 << DIST_EXTRA[code])
        for d in range(lo, min(hi, 257)):
            lut[d - 1] = code
        if lo > 256 or hi > 257:
            for d in range(max(lo, 257), hi):
                lut[256 + ((d - 1) >> 7)] = code
    return lut


DIST_CODE_LUT = _gen_dist_code_lut()


def dist_to_code(dist):
    """Vectorized distance (1..32768) -> distance code (0..29)."""
    dist = np.asarray(dist)
    small = DIST_CODE_LUT[np.clip(dist - 1, 0, 255)]
    big = DIST_CODE_LUT[256 + np.clip((dist - 1) >> 7, 0, 255)]
    return np.where(dist <= 256, small, big)


def length_to_code(length):
    """Vectorized match length (3..258) -> length code (257..285)."""
    return LENGTH_CODE_LUT[np.asarray(length) - 3]


# ---------------------------------------------------------------------------
# Canonical Huffman code construction (RFC 1951 §3.2.2)
# ---------------------------------------------------------------------------
def canonical_codes(lengths: np.ndarray, max_bits: int = MAX_BITS) -> np.ndarray:
    """Canonical Huffman codes for the given code lengths, in natural
    (MSB-first) bit order; see reverse_bits for the LSB-first form."""
    lengths = np.asarray(lengths, dtype=np.int64)
    bl_count = np.bincount(lengths, minlength=max_bits + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_bits + 1, dtype=np.int64)
    code = 0
    for bits in range(1, max_bits + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    codes = np.zeros(len(lengths), dtype=np.int64)
    for sym in range(len(lengths)):
        ln = lengths[sym]
        if ln != 0:
            codes[sym] = next_code[ln]
            next_code[ln] += 1
    return codes.astype(np.uint32)


def reverse_bits(codes, lengths, max_bits: int = MAX_BITS):
    """Bit-reverse each code over its own length (vectorized)."""
    codes = np.asarray(codes, dtype=np.uint32)
    lengths = np.asarray(lengths)
    rev = np.zeros_like(codes)
    c = codes.copy()
    for _ in range(max_bits):
        rev = (rev << 1) | (c & 1)
        c >>= 1
    return (rev >> (max_bits - lengths).astype(np.uint32)) * (lengths > 0)


# ---------------------------------------------------------------------------
# Fixed (static) Huffman trees (RFC 1951 §3.2.6)
# ---------------------------------------------------------------------------
def _gen_fixed_trees():
    lit_lengths = np.zeros(288, dtype=np.int32)
    lit_lengths[0:144] = 8
    lit_lengths[144:256] = 9
    lit_lengths[256:280] = 7
    lit_lengths[280:288] = 8
    dist_lengths = np.full(30, 5, dtype=np.int32)
    lit_codes = canonical_codes(lit_lengths)
    dist_codes = canonical_codes(dist_lengths)
    return lit_lengths, lit_codes, dist_lengths, dist_codes


(FIXED_LIT_LENGTHS, FIXED_LIT_CODES,
 FIXED_DIST_LENGTHS, FIXED_DIST_CODES) = _gen_fixed_trees()

# LSB-first (bitstream-ready) versions
FIXED_LIT_CODES_REV = reverse_bits(FIXED_LIT_CODES, FIXED_LIT_LENGTHS)
FIXED_DIST_CODES_REV = reverse_bits(FIXED_DIST_CODES, FIXED_DIST_LENGTHS)


# ---------------------------------------------------------------------------
# CRC-32 tables
# ---------------------------------------------------------------------------
def _gen_crc_table() -> np.ndarray:
    """Slicing tables T[k][b] = crc contribution of byte b seen k bytes ago."""
    t0 = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = np.uint64(i)
        for _ in range(8):
            c = (c >> np.uint64(1)) ^ (np.uint64(CRC_POLY) * (c & np.uint64(1)))
        t0[i] = c
    tables = np.zeros((8, 256), dtype=np.uint64)
    tables[0] = t0
    for k in range(1, 8):
        prev = tables[k - 1]
        tables[k] = (prev >> np.uint64(8)) ^ t0[(prev & np.uint64(0xFF)).astype(np.int64)]
    return tables.astype(np.uint32)


CRC_TABLES = _gen_crc_table()
CRC_TABLE = CRC_TABLES[0]
