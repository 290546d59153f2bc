"""CRC-32 (gzip polynomial): the host runtime's C route first
(`native/zng_host.c`), else slicing-by-8 in numpy; and the exact GF(2)
combine (zlib-ng crc32.c, crc32_braid_comb.c semantics; the routes of
`zlibng_tpu/checksum/crc32.py`)."""
from __future__ import annotations

import numpy as np

from .. import native
from ..format.constants import CRC_POLY, CRC_TABLE, CRC_TABLES


def crc32(data, value: int = 0) -> int:
    """CRC-32 of `data`, seeded with `value` (matches zlib crc32())."""
    if native.available():
        return native.crc32(data, value)
    buf = np.frombuffer(memoryview(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data.astype(np.uint8, copy=False)
    crc = np.uint32(value) ^ np.uint32(0xFFFFFFFF)
    n = buf.size
    head = min(n, (-n) % 8)
    for b in buf[:head]:
        crc = (crc >> np.uint32(8)) ^ CRC_TABLE[(crc ^ b) & np.uint32(0xFF)]
    body = buf[head:]
    if body.size >= 8:
        blocks = body[: body.size - body.size % 8].reshape(-1, 8).astype(np.uint32)
        for row in blocks:
            x = crc ^ (row[0] | (row[1] << np.uint32(8))
                       | (row[2] << np.uint32(16)) | (row[3] << np.uint32(24)))
            crc = (CRC_TABLES[7][x & np.uint32(0xFF)]
                   ^ CRC_TABLES[6][(x >> np.uint32(8)) & np.uint32(0xFF)]
                   ^ CRC_TABLES[5][(x >> np.uint32(16)) & np.uint32(0xFF)]
                   ^ CRC_TABLES[4][(x >> np.uint32(24)) & np.uint32(0xFF)]
                   ^ CRC_TABLES[3][row[4]]
                   ^ CRC_TABLES[2][row[5]]
                   ^ CRC_TABLES[1][row[6]]
                   ^ CRC_TABLES[0][row[7]])
        tail = body[body.size - body.size % 8:]
    else:
        tail = body
    for b in tail:
        crc = (crc >> np.uint32(8)) ^ CRC_TABLE[(crc ^ b) & np.uint32(0xFF)]
    return int(crc ^ np.uint32(0xFFFFFFFF))


# ---------------------------------------------------------------------------
# GF(2) combine machinery (crc32_braid_comb.c)
# ---------------------------------------------------------------------------
def _gf2_matrix_times(mat: np.ndarray, vec: int) -> int:
    """A GF(2) operator (32 column vectors) applied to a 32-bit vector."""
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= int(mat[i])
        vec >>= 1
        i += 1
    return out


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose GF(2) operators: (a∘b), matrices stored as 32 column vectors."""
    return np.array([_gf2_matrix_times(a, int(col)) for col in b],
                    dtype=np.uint64)


def _shift_operator(len2: int) -> np.ndarray:
    """Operator advancing a CRC register by len2 zero bytes, via binary
    exponentiation of the one-zero-bit operator."""
    m = np.zeros(32, dtype=np.uint64)
    m[0] = CRC_POLY
    for i in range(1, 32):
        m[i] = np.uint64(1) << np.uint64(i - 1)
    result = np.array([np.uint64(1) << np.uint64(i) for i in range(32)],
                      dtype=np.uint64)  # identity
    n = len2 * 8  # bits
    while n:
        if n & 1:
            result = _gf2_matmul(m, result)
        n >>= 1
        if n:
            m = _gf2_matmul(m, m)
    return result


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32(A||B) from crc32(A), crc32(B) and |B| = len2
    (zng_crc32_combine)."""
    return _gf2_matrix_times(_shift_operator(len2), crc1) ^ crc2
