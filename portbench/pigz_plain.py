"""pigz's zlib layout in plain Python: the stream `pigz -z -b 128` writes,
made with the standard library's zlib alone (no torch, no package of this
repository). The benchmark's own copy of `tests/pigz_plain.py`, so that
the yardstick does not move when the tests' files do; the entry
`compress_multichip` puts it in the program's place as its control.

The input is cut into blocks of `block` bytes (pigz's -b, 128 KiB by
default). Each block is raw deflate at `level` (memLevel 8, the default
strategy), primed with the last 32 KiB of the block before it as a preset
dictionary ("The input blocks, while compressed independently, have the
last 32K of the previous block loaded as a preset dictionary", pigz.1),
and ends with Z_SYNC_FLUSH (an empty stored block, on a byte boundary)
except the last, which ends with Z_FINISH. A zlib header goes first and
the adler32 of the whole input last, as pigz.c's put_header and
put_trailer write them with -z.

Departures from pigz.c: with zlib 1.2.6 or later pigz ends a block with
Z_BLOCK and empty static blocks where those reach a byte boundary, and
falls back to Z_SYNC_FLUSH otherwise; here every block but the last takes
Z_SYNC_FLUSH (at most a few bytes more a block).
"""
from __future__ import annotations

import zlib

DICT = 32768            # pigz.c DICT: the history each block is primed with


def zlib_header(level: int) -> bytes:
    """pigz.c's zlib header: deflate with a 32K window and its level clue
    (3 at -9 and above, 0 at -1, 1 at -6 to -8, 2 below -6), padded to a
    multiple of 31."""
    clue = 3 if level >= 9 else 0 if level == 1 else 1 if level >= 6 else 2
    head = (0x78 << 8) + (clue << 6)
    head += 31 - head % 31
    return head.to_bytes(2, "big")


def compress(data, level: int = 6, block: int = 128 << 10) -> bytes:
    """`data` as pigz -z -b (block / 1024) at `level` lays it out."""
    data = bytes(data)
    parts = [zlib_header(level)]
    starts = range(0, max(1, len(data)), block)
    for i, start in enumerate(starts):
        if start:
            co = zlib.compressobj(level, zlib.DEFLATED, -15, 8,
                                  zlib.Z_DEFAULT_STRATEGY,
                                  zdict=data[max(0, start - DICT):start])
        else:
            co = zlib.compressobj(level, zlib.DEFLATED, -15, 8,
                                  zlib.Z_DEFAULT_STRATEGY)
        last = i == len(starts) - 1
        parts.append(co.compress(data[start:start + block]))
        parts.append(co.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
    parts.append(zlib.adler32(data).to_bytes(4, "big"))
    return b"".join(parts)
