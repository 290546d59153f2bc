"""Token rendering and LSB-first packing of (value, nbits) tokens on the
host (trees_emit.h send_bits analog): the host encoder's emitter, and the
few tokens the device path's stitch renders. A copy of
`zlibng_tpu/huffman/bitpack.py`."""
from __future__ import annotations

import numpy as np

from ..format.constants import (
    DIST_BASE, DIST_EXTRA, LENGTH_BASE, LENGTH_EXTRA, dist_to_code,
    length_to_code,
)


def token_bits(sel_len: np.ndarray, sel_val: np.ndarray, sel_dist: np.ndarray,
               lit_lens: np.ndarray, lit_codes: np.ndarray,
               dist_lens: np.ndarray, dist_codes: np.ndarray):
    """Render tokens to (value u64, nbits i64) pairs: sel_len (T,) match
    length (0: literal sel_val), sel_dist (T,) distance, against Huffman
    tables whose codes are LSB-first."""
    sel_len = sel_len.astype(np.int64)
    is_match = sel_len > 0

    lit_sym = np.where(is_match, 0, sel_val).astype(np.int64)
    lcode_sym = np.where(is_match, length_to_code(np.maximum(sel_len, 3)),
                         lit_sym)
    code0 = lit_codes[lcode_sym].astype(np.uint64)
    n0 = lit_lens[lcode_sym].astype(np.int64)

    li = np.maximum(lcode_sym - 257, 0)
    lextra_n = np.where(is_match, LENGTH_EXTRA[li], 0).astype(np.int64)
    lextra_v = (sel_len - LENGTH_BASE[li]).astype(np.uint64)

    d = np.maximum(sel_dist, 1)
    dsym = dist_to_code(d).astype(np.int64)
    dcode = dist_codes[dsym].astype(np.uint64)
    dn = np.where(is_match, dist_lens[dsym], 0).astype(np.int64)
    dextra_n = np.where(is_match, DIST_EXTRA[dsym], 0).astype(np.int64)
    dextra_v = (d - DIST_BASE[dsym]).astype(np.uint64)

    sh1 = n0
    sh2 = sh1 + lextra_n
    sh3 = sh2 + dn
    value = code0
    value = value | np.where(is_match, lextra_v << sh1.astype(np.uint64),
                             0).astype(np.uint64)
    value = value | np.where(is_match, dcode << sh2.astype(np.uint64),
                             0).astype(np.uint64)
    value = value | np.where(is_match, dextra_v << sh3.astype(np.uint64),
                             0).astype(np.uint64)
    nbits = n0 + lextra_n + dn + dextra_n
    return value, nbits


def pack_bits(values: np.ndarray, nbits: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack (value, nbits) tokens LSB-first into bytes.

    Returns (bytes uint8 array, total_bits). Final partial byte zero-padded.
    """
    values = values.astype(np.uint64)
    nbits = nbits.astype(np.int64)
    offsets = np.zeros(len(nbits) + 1, dtype=np.int64)
    np.cumsum(nbits, out=offsets[1:])
    total_bits = int(offsets[-1])
    nbytes = (total_bits + 7) >> 3
    start = offsets[:-1]
    shifted = values << (start & 7).astype(np.uint64)       # <= 48+7 = 55 bits
    byte0 = start >> 3
    k = np.arange(7, dtype=np.uint64)
    contrib = (shifted[:, None] >> (k * 8)[None, :]).astype(np.int64) & 0xFF
    idx = byte0[:, None] + np.arange(7, dtype=np.int64)[None, :]
    out = np.zeros(nbytes + 8, dtype=np.int64)
    np.add.at(out, idx, contrib)     # disjoint bits => add == or, no carries
    return out[:nbytes].astype(np.uint8), total_bits
