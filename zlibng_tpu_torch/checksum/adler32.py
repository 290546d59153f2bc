"""Adler-32 checksum, vectorized in numpy (zlib-ng adler32.c semantics).

Per-block (sum, weighted-sum) reductions merged in closed form, the same
arithmetic as the numpy path of `zlibng_tpu/checksum/adler32.py`.
"""
from __future__ import annotations

import numpy as np

from ..format.constants import ADLER_BASE, ADLER_NMAX

_BASE = ADLER_BASE


def adler32(data, value: int = 1) -> int:
    """Adler-32 of `data` (bytes or uint8 ndarray), seeded with `value`."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data.astype(np.uint8, copy=False)
    s1 = np.uint64(value & 0xFFFF)
    s2 = np.uint64((value >> 16) & 0xFFFF)
    n = buf.size
    if n == 0:
        # zlib reduces the seed parts even for empty input
        s1 %= np.uint64(_BASE)
        s2 %= np.uint64(_BASE)
        return int((s2 << np.uint64(16)) | s1)
    # uint64 accumulators allow blocks far larger than NMAX
    block = ADLER_NMAX * 256
    for start in range(0, n, block):
        chunk = buf[start:start + block].astype(np.uint64)
        m = chunk.size
        csum = chunk.sum()
        # weights m, m-1, ..., 1 applied to chunk bytes
        wsum = (chunk * np.arange(m, 0, -1, dtype=np.uint64)).sum()
        s2 = (s2 + np.uint64(m) * s1 + wsum) % np.uint64(_BASE)
        s1 = (s1 + csum) % np.uint64(_BASE)
    return int((s2 << np.uint64(16)) | s1)
