"""LSB-first packing of (value, nbits) tokens on the host (trees_emit.h
send_bits analog); used for the few tokens the host stitch renders."""
from __future__ import annotations

import numpy as np


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
