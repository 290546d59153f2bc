"""CRC-32 (gzip polynomial), slicing-by-8 in numpy (zlib-ng crc32.c
semantics; the numpy path of `zlibng_tpu/checksum/crc32.py`)."""
from __future__ import annotations

import numpy as np

from ..format.constants import CRC_TABLE, CRC_TABLES


def crc32(data, value: int = 0) -> int:
    """CRC-32 of `data`, seeded with `value` (matches zlib crc32())."""
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
