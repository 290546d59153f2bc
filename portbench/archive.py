"""The decode cells' inputs, made by the standard library's zlib alone.

`indexed` is a frozen copy of `chip_smoke.py:indexed_blob` that returns
the index as two lists instead of the port's `StreamIndex`: raw DEFLATE at
`level` with a Z_FULL_FLUSH every `segment` bytes (pigz-style independent
segments), `comp_offsets` and `out_offsets` with one entry past the last
segment. `stream` is one zlib, gzip or raw stream with no flush.
"""
from __future__ import annotations

import zlib


def indexed(data: bytes, level: int = 6, segment: int = 1 << 20
            ) -> tuple[bytes, list, list]:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    blob = bytearray()
    comp, out = [], []
    for pos in range(0, len(data), segment):
        comp.append(len(blob))
        out.append(pos)
        last = pos + segment >= len(data)
        blob += co.compress(data[pos:pos + segment]) + co.flush(
            zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH)
    comp.append(len(blob))
    out.append(len(data))
    return bytes(blob), comp, out


def stream(data: bytes, level: int = 6, wbits: int = 15) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, wbits)
    return co.compress(data) + co.flush()
