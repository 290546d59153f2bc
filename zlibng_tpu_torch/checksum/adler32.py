"""Adler-32 checksum (zlib-ng adler32.c semantics): the host runtime's C
route first (`native/zng_host.c`), else per-block (sum, weighted-sum)
reductions in numpy merged in closed form; and the exact combine of two
checksums. The routes of `zlibng_tpu/checksum/adler32.py`.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..format.constants import ADLER_BASE, ADLER_NMAX

_BASE = ADLER_BASE


def adler32(data, value: int = 1) -> int:
    """Adler-32 of `data` (bytes or uint8 ndarray), seeded with `value`."""
    if native.available():
        return native.adler32(data, value)
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


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """adler32(A||B) from adler32(A), adler32(B) and |B| = len2 (closed
    form, zlib-ng adler32.c:32-55)."""
    rem = len2 % _BASE
    s1a = adler1 & 0xFFFF
    s2a = (adler1 >> 16) & 0xFFFF
    s1b = adler2 & 0xFFFF
    s2b = (adler2 >> 16) & 0xFFFF
    s1 = (s1a + s1b + _BASE - 1) % _BASE
    s2 = (s2a + s2b + rem * s1a + _BASE - rem) % _BASE
    return (s2 << 16) | s1
