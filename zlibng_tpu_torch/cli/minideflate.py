"""minideflate-equivalent CLI (zlib-ng test/minideflate.c): raw, zlib or
gzip streams with window-bits, mem-level, strategy and flush knobs, on the
host (Deflate and Inflate). A copy of `zlibng_tpu/cli/minideflate.py`.

Usage: python -m zlibng_tpu_torch.cli.minideflate [-c] [-d] [-0..-9]
                                   [-w bits] [-m level] [-s strategy] [file]
  -w bits : windowBits (negative=raw, +16=gzip; default 15)
  -m lvl  : memLevel (1..9, default 8)
  -s n    : strategy (0..4)
  -d      : decompress
"""
from __future__ import annotations

import sys

from ..stream.api import Deflate, Inflate, Z_FINISH


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    level, wbits, memlevel, strategy = 6, 15, 8, 0
    decompress = False
    path = None
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-d":
            decompress = True
        elif a == "-c":
            pass
        elif len(a) == 2 and a[0] == "-" and a[1].isdigit():
            level = int(a[1])
        elif a == "-w":
            i += 1
            wbits = int(args[i])
        elif a == "-m":
            i += 1
            memlevel = int(args[i])
        elif a == "-s":
            i += 1
            strategy = int(args[i])
        elif a == "--help":
            print(__doc__)
            return 0
        else:
            path = a
        i += 1
    if path:
        with open(path, "rb") as f:
            data = f.read()
    else:
        data = sys.stdin.buffer.read()
    if decompress:
        inf = Inflate(wbits=wbits)
        out = inf.decompress(data, finish=True)
        sys.stdout.buffer.write(out)
    else:
        d = Deflate(level=level, wbits=wbits, mem_level=memlevel,
                    strategy=strategy)
        sys.stdout.buffer.write(d.compress(data, Z_FINISH))
    return 0


if __name__ == "__main__":
    sys.exit(main())
