"""minigzip-equivalent CLI (zlib-ng test/minigzip.c): gzip-like
compress/decompress with level and strategy flags. A copy of
`zlibng_tpu/cli/minigzip.py`.

Usage: python -m zlibng_tpu_torch.cli.minigzip [-c] [-d] [-k] [-f]
                                   [-h|-R|-F] [-T] [-t] [-0..-9] [files...]
  -c : write to stdout          -d : decompress
  -k : keep input files         -f : force overwrite
  -h : huffman-only strategy    -R : RLE strategy    -F : fixed strategy
  -T : transparent write (no compression, stored)
  -t : compress on the card: compress_cuda's block-parallel pipeline
       (raises without a CUDA card)
Without -t every path runs on the host (GzFile over Deflate and Inflate).
"""
from __future__ import annotations

import os
import sys

from ..stream.deflate import Z_FIXED, Z_HUFFMAN_ONLY, Z_RLE
from ..stream.gzfile import GzFile

GZ_SUFFIX = ".gz"


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write(path, data) -> None:
    with open(path, "wb") as f:
        f.write(data)


def compress_file(path, level, strategy, keep, to_stdout, use_tpu,
                  device="cuda"):
    """Compress `path` (stdin when None) to path + ".gz" or stdout. With
    use_tpu (-t) the gzip member is compress_cuda's on `device`: the card
    unless a caller passes "cpu"."""
    data = _read(path) if path else sys.stdin.buffer.read()
    if use_tpu:
        from ..ops.deflate import compress_cuda
        gz = compress_cuda(data, level=level, wbits=31, strategy=strategy,
                           device=device)
    if to_stdout:
        out = sys.stdout.buffer
        if use_tpu:
            out.write(gz)
        else:
            g = GzFile(fileobj=_Raw(out), mode="wb", level=level,
                       strategy=strategy)
            g.write(data)
            g.close()
        return
    dst = path + GZ_SUFFIX
    if use_tpu:
        _write(dst, gz)
    else:
        with GzFile(dst, "wb", level=level, strategy=strategy) as g:
            g.write(data)
    if not keep:
        os.unlink(path)


def decompress_file(path, keep, to_stdout):
    if path:
        with GzFile(path, "rb") as src:
            data = src.read()
    else:
        data = GzFile(fileobj=sys.stdin.buffer, mode="rb").read()
    if to_stdout or not path:
        sys.stdout.buffer.write(data)
    else:
        dst = (path[:-len(GZ_SUFFIX)] if path.endswith(GZ_SUFFIX)
               else path + ".out")
        _write(dst, data)
        if not keep:
            os.unlink(path)


class _Raw:
    def __init__(self, f):
        self.f = f

    def write(self, b):
        return self.f.write(b)

    def flush(self):
        self.f.flush()

    def close(self):
        self.f.flush()

    def tell(self):
        return 0


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    level, strategy = 6, 0
    decompress = keep = to_stdout = use_tpu = False
    files = []
    for a in args:
        if a == "-c":
            to_stdout = True
        elif a == "-d":
            decompress = True
        elif a == "-k":
            keep = True
        elif a == "-f":
            pass
        elif a == "-h":
            strategy = Z_HUFFMAN_ONLY
        elif a == "-R":
            strategy = Z_RLE
        elif a == "-F":
            strategy = Z_FIXED
        elif a == "-T":
            level = 0
        elif a == "-t":
            use_tpu = True
        elif len(a) == 2 and a[0] == "-" and a[1].isdigit():
            level = int(a[1])
        elif a == "--help":
            print(__doc__)
            return 0
        else:
            files.append(a)
    if not files:
        files = [None]
        to_stdout = True
    for path in files:
        if decompress:
            decompress_file(path, keep, to_stdout)
        else:
            compress_file(path, level, strategy, keep, to_stdout, use_tpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
