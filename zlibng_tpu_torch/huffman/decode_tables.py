"""Huffman decode table construction (inftrees.c acceptance rules).

The port's copy of `zlibng_tpu/huffman/decode_tables.py`: validates
code-length sets (oversubscribed / incomplete) exactly where zlib-ng's
inftrees.c rejects them, and builds a flat 2^max_len LSB-first lookup table
(one gather per symbol) instead of the two-level root/sub-table walk; the
packed table's fill runs in the host runtime (`native/zng_host.c`
zng_fill_lut) when it is built, else in numpy.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from ..format.constants import canonical_codes, reverse_bits

# Table kinds (inftrees.h codetype)
CODES = 0   # code-length codes
LENS = 1    # literal/length codes
DISTS = 2   # distance codes


class InvalidCodeError(ValueError):
    """Raised for oversubscribed/unacceptably-incomplete code length sets."""


def validate_lengths(lengths: np.ndarray, kind: int) -> int:
    """Kraft accounting with inftrees.c acceptance rules (inftrees.c:98-130).
    Returns the number of used symbols; raises InvalidCodeError exactly
    where the reference rejects."""
    used = lengths > 0
    nsyms_used = int(used.sum())
    if nsyms_used == 0:
        return 0
    max_used = int(lengths[used].max())
    bl_count = np.bincount(lengths[used], minlength=16)
    left = 1
    for bits in range(1, 16):
        left <<= 1
        left -= int(bl_count[bits]) if bits < len(bl_count) else 0
        if left < 0:
            raise InvalidCodeError("oversubscribed code length set")
    if left > 0 and (kind == CODES or max_used != 1):
        raise InvalidCodeError("incomplete code length set")
    return nsyms_used


def build_packed_lut(lengths: np.ndarray, kind: int,
                     max_len: int = 15) -> np.ndarray:
    """Flat packed decode LUT: int32 entries sym<<4|nbits, invalid < 0."""
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    if validate_lengths(lengths, kind) == 0:
        # error-forcing table, like inftrees.c's max==0 path
        return np.full(1 << max(max_len, 1), -16, dtype=np.int32)
    max_len = max(max_len, int(lengths.max()))
    lib = native.lib()
    if lib is not None:
        out = np.empty(1 << max_len, dtype=np.int32)
        lib.zng_fill_lut(ctypes.c_void_p(lengths.ctypes.data),
                         lengths.size, max_len,
                         ctypes.c_void_p(out.ctypes.data))
        return out
    sym, bits = build_decode_lut(lengths, kind, max_len=max_len)
    return ((sym.astype(np.int64) << 4) | bits).astype(np.int32)


def build_decode_lut(lengths: np.ndarray, kind: int,
                     max_len: int | None = None):
    """Flat LSB-first decode LUT from per-symbol code lengths: returns
    (sym, nbits) where, for any `max_len`-bit peek p (LSB first), sym[p] is
    the decoded symbol and nbits[p] the bits to consume. Raises
    InvalidCodeError where the reference rejects: oversubscribed, or
    incomplete unless the set has one used code of length 1 and kind !=
    CODES (inftrees.c:122-130)."""
    lengths = np.asarray(lengths, dtype=np.int32)
    if max_len is None:
        max_len = int(lengths.max(initial=0))
    if validate_lengths(lengths, kind) == 0:
        # no symbols at all: like inftrees.c's max==0 path, succeed with an
        # error-forcing table so the decode reports the error
        size = 1 << max(max_len, 1)
        return (np.full(size, -1, dtype=np.int32),
                np.zeros(size, dtype=np.int32))
    max_len = max(max_len, int(lengths.max()))
    size = 1 << max_len
    sym_lut = np.full(size, -1, dtype=np.int32)
    bits_lut = np.zeros(size, dtype=np.int32)
    codes = canonical_codes(lengths, max_bits=max_len)
    rev = reverse_bits(codes, lengths, max_bits=max_len).astype(np.int64)
    for ln in range(1, max_len + 1):
        syms = np.nonzero(lengths == ln)[0]
        if syms.size == 0:
            continue
        fill = np.arange(1 << (max_len - ln), dtype=np.int64) << ln
        idx = (rev[syms][:, None] + fill[None, :]).ravel()
        sym_lut[idx] = np.repeat(syms.astype(np.int32), fill.size)
        bits_lut[idx] = ln
    return sym_lut, bits_lut
