"""Native host runtime: ctypes bindings over `zng_host.c`.

The port's copy of `zlibng_tpu/native/__init__.py`. The shared object is
built at first use with the system C compiler into `zlibng_tpu_torch/_build/`
(beside the CUDA kernels' libraries), under a name keyed by a hash of the
source and the flags; a later process reuses it. Every caller has a numpy
route: `lib()` returns None when no compiler is found, and callers cope.
Setting `_lib = False` forces every caller onto its numpy route (the serial
decoder caches its own handle: `stream.inflate_serial._native_lib`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "zng_host.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lib = None          # None = not tried, False = unavailable, else CDLL

_CFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-lm"]
_CFLAGS_PORTABLE = ["-O3", "-fPIC", "-shared", "-lm"]


def _build(so_path: Path) -> bool:
    """Compile into a per-process temporary, then rename it into place, so
    concurrent processes (test workers) never load a half-written file."""
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang", "g++"):
        if not cc:
            continue
        for flags in (_CFLAGS, _CFLAGS_PORTABLE):
            cmd = [cc, *flags, "-o", str(tmp), str(_SRC)]
            if cc.endswith("g++") or cc.endswith("clang++"):
                cmd.insert(1, "-x")
                cmd.insert(2, "c")
            try:
                r = subprocess.run(cmd, capture_output=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired):
                continue
            if r.returncode == 0 and tmp.exists():
                os.replace(tmp, so_path)
                return True
    tmp.unlink(missing_ok=True)
    return False


def library_path() -> Path:
    key = _SRC.read_bytes() + repr(_CFLAGS).encode()
    return BUILD_DIR / f"zng_host-{hashlib.sha256(key).hexdigest()[:16]}.so"


def lib():
    """The loaded native library, building it if needed, or None."""
    global _lib
    if _lib is not None:
        return _lib or None
    try:
        so_path = library_path()
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            if not _build(so_path):
                _lib = False
                return None
        lb = ctypes.CDLL(str(so_path))
    except OSError:
        _lib = False
        return None
    lb.zng_adler32.restype = ctypes.c_uint32
    lb.zng_adler32.argtypes = [ctypes.c_void_p, ctypes.c_long,
                               ctypes.c_uint32]
    lb.zng_crc32.restype = ctypes.c_uint32
    lb.zng_crc32.argtypes = [ctypes.c_void_p, ctypes.c_long,
                             ctypes.c_uint32]
    lb.zng_fill_lut.restype = None
    lb.zng_fill_lut.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.c_int, ctypes.c_void_p]
    lb.zng_read_dyn_header.restype = ctypes.c_long
    lb.zng_read_dyn_header.argtypes = [
        ctypes.c_void_p, ctypes.c_long,                 # data, nbytes
        ctypes.POINTER(ctypes.c_long),                  # bitpos
        ctypes.c_void_p,                                # lengths out
        ctypes.POINTER(ctypes.c_long),                  # hlit
        ctypes.POINTER(ctypes.c_long),                  # hdist
        ctypes.c_void_p, ctypes.c_void_p,               # lit/dist LUTs
        ctypes.c_void_p,                                # lut_bits[2]
    ]
    lb.zng_inflate_stream.restype = ctypes.c_long
    lb.zng_inflate_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_long,                 # data, nbytes
        ctypes.POINTER(ctypes.c_long),                  # bitpos
        ctypes.c_void_p,                                # state int64[8]
        ctypes.c_void_p, ctypes.c_long,                 # lit tbl2, cap
        ctypes.c_void_p, ctypes.c_long,                 # dist tbl2, cap
        ctypes.c_void_p, ctypes.c_long,                 # out, out_cap
        ctypes.POINTER(ctypes.c_long),                  # out_len
        ctypes.c_long, ctypes.c_int,                    # wsize, finish
        ctypes.POINTER(ctypes.c_long),                  # ncodes
        ctypes.c_int,                                   # stop_after_block
    ]
    lb.zng_decode_huff.restype = ctypes.c_long
    lb.zng_decode_huff.argtypes = [
        ctypes.c_void_p, ctypes.c_long,                 # data, nbytes
        ctypes.POINTER(ctypes.c_long),                  # bitpos
        ctypes.c_void_p, ctypes.c_void_p,               # lit/dist LUTs
        ctypes.c_void_p, ctypes.c_long,                 # out, out_cap
        ctypes.POINTER(ctypes.c_long),                  # out_len
        ctypes.c_long, ctypes.c_int,                    # wsize, finish
        ctypes.POINTER(ctypes.c_long),                  # ncodes
        ctypes.c_int, ctypes.c_int,                     # lit/dist bits
    ]
    lb.zng_huff_table.restype = None
    lb.zng_huff_table.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int,   # freqs,n,maxbits
        ctypes.c_void_p, ctypes.c_void_p,               # lengths, codes
    ]
    lb.zng_dyn_header.restype = ctypes.c_long
    lb.zng_dyn_header.argtypes = [
        ctypes.c_void_p, ctypes.c_long,                 # lit lengths, n
        ctypes.c_void_p, ctypes.c_long,                 # dist lengths, n
        ctypes.c_void_p, ctypes.c_void_p,               # tok val/bits
        ctypes.POINTER(ctypes.c_long),                  # total_bits
    ]
    lb.zng_est_block_bits.restype = ctypes.c_double
    lb.zng_est_block_bits.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _lib = lb
    return lb


def available() -> bool:
    return lib() is not None


def _ptr(data):
    """(address, nbytes, keepalive) for bytes/bytearray/memoryview/ndarray
    without copying. np.frombuffer holds the buffer by a plain acyclic
    reference (ctypes from_buffer keepalives form reference cycles, which
    would keep the serial decoder's scratch buffers looking held until a gc
    pass)."""
    if hasattr(data, "ctypes"):                       # numpy ndarray
        return ctypes.c_void_p(data.ctypes.data), data.nbytes, data
    if isinstance(data, bytes):
        return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), \
            len(data), data
    import numpy as np
    arr = np.frombuffer(memoryview(data), np.uint8)
    return ctypes.c_void_p(arr.ctypes.data), arr.nbytes, arr


def huff_table(freqs, max_bits: int):
    """Native encode-side Huffman build: (lengths, lsb-first codes), both
    int32 arrays of len(freqs), equal to the numpy route's (same
    tie-breaking); the caller guarantees `available()` and
    len(freqs) <= 320."""
    import numpy as np
    f = np.ascontiguousarray(freqs, np.int64)
    lengths = np.empty(f.size, np.int32)
    codes = np.empty(f.size, np.int32)
    lib().zng_huff_table(ctypes.c_void_p(f.ctypes.data), f.size, max_bits,
                         ctypes.c_void_p(lengths.ctypes.data),
                         ctypes.c_void_p(codes.ctypes.data))
    return lengths, codes


def dyn_header(lit_lengths, dist_lengths):
    """Native dynamic-header build: (tok_val, tok_bits, total_bits)."""
    import numpy as np
    ll = np.ascontiguousarray(lit_lengths, np.int32)
    dl = np.ascontiguousarray(dist_lengths, np.int32)
    tv = np.empty(720, np.int32)
    tb = np.empty(720, np.int32)
    total = ctypes.c_long(0)
    nt = lib().zng_dyn_header(ctypes.c_void_p(ll.ctypes.data), ll.size,
                              ctypes.c_void_p(dl.ctypes.data), dl.size,
                              ctypes.c_void_p(tv.ctypes.data),
                              ctypes.c_void_p(tb.ctypes.data),
                              ctypes.byref(total))
    return tv[:nt], tb[:nt], int(total.value)


def adler32(data, value: int = 1) -> int:
    """Native adler32; the caller guarantees `available()`."""
    p, n, keep = _ptr(data)
    return int(lib().zng_adler32(p, n, value & 0xFFFFFFFF))


def crc32(data, value: int = 0) -> int:
    """Native crc32; the caller guarantees `available()`."""
    p, n, keep = _ptr(data)
    return int(lib().zng_crc32(p, n, value & 0xFFFFFFFF))
