"""Drop-in replacement for Python's ``zlib`` module, backed by the port.

A copy of `zlibng_tpu/pyzlib.py`: ``import zlibng_tpu_torch.pyzlib as
zlib`` and callers of the stdlib surface keep working: the module
functions, ``compressobj``/``decompressobj`` with flush modes, zdict,
``max_length`` with ``unconsumed_tail``, ``unused_data``, ``eof``,
``copy()`` and a compatible ``error`` exception (zlib-ng's zlib-compatible
flavour, zbuild.h:80-86, zlib.h.in). Everything runs on the host.
"""
from __future__ import annotations

from .checksum.adler32 import adler32 as _adler32
from .checksum.crc32 import crc32 as _crc32
from .errors import Error as error  # noqa: N812  (stdlib zlib.error name)
from .stream.api import (
    Deflate, Inflate,
    Z_BLOCK, Z_FINISH, Z_FULL_FLUSH, Z_NO_FLUSH, Z_PARTIAL_FLUSH,
    Z_SYNC_FLUSH, Z_TREES,
)
from .stream.deflate import (
    Z_DEFAULT_STRATEGY, Z_FILTERED, Z_FIXED, Z_HUFFMAN_ONLY, Z_RLE,
    compress_bound,
)
from .stream.deflate import compress as _compress_host
from .stream.inflate import decompress as _decompress_host

Z_DEFAULT_COMPRESSION = -1
Z_DEFLATED = 8

__all__ = [
    "compress", "decompress", "compressobj", "decompressobj",
    "adler32", "crc32", "compressBound", "error",
    "Z_NO_FLUSH", "Z_PARTIAL_FLUSH", "Z_SYNC_FLUSH", "Z_FULL_FLUSH",
    "Z_FINISH", "Z_BLOCK", "Z_TREES",
    "Z_DEFAULT_COMPRESSION", "Z_BEST_SPEED", "Z_BEST_COMPRESSION",
    "Z_DEFAULT_STRATEGY", "Z_FILTERED", "Z_HUFFMAN_ONLY", "Z_RLE", "Z_FIXED",
    "DEFLATED", "DEF_MEM_LEVEL", "DEF_BUF_SIZE", "MAX_WBITS",
    "ZLIBNG_TPU_VERSION",
]

Z_BEST_SPEED = 1
Z_BEST_COMPRESSION = 9
DEFLATED = Z_DEFLATED
DEF_MEM_LEVEL = 8
DEF_BUF_SIZE = 16384
MAX_WBITS = 15
ZLIBNG_TPU_VERSION = "2.2.2"


def adler32(data, value: int = 1) -> int:
    return _adler32(bytes(data), value & 0xFFFFFFFF)


def crc32(data, value: int = 0) -> int:
    return _crc32(bytes(data), value & 0xFFFFFFFF)


def compress(data, level: int = Z_DEFAULT_COMPRESSION, wbits: int = MAX_WBITS):
    if level == Z_DEFAULT_COMPRESSION:
        level = 6
    return _compress_host(bytes(data), level=level, wbits=wbits)


def decompress(data, wbits: int = MAX_WBITS, bufsize: int = DEF_BUF_SIZE):
    return _decompress_host(bytes(data), wbits=wbits)


def compressBound(n: int) -> int:  # noqa: N802 (zlib-ng spelling)
    return compress_bound(n)


class _Compress:
    """zlib.compressobj-compatible wrapper over stream.api.Deflate."""

    def __init__(self, level, method, wbits, memLevel, strategy, zdict):
        if level == Z_DEFAULT_COMPRESSION:
            level = 6
        self._d = Deflate(level=level, method=method, wbits=wbits,
                          mem_level=memLevel, strategy=strategy,
                          dictionary=zdict)

    def compress(self, data) -> bytes:
        return self._d.compress(bytes(data), Z_NO_FLUSH)

    def flush(self, mode: int = Z_FINISH) -> bytes:
        if mode == Z_NO_FLUSH:
            return b""
        return self._d.compress(b"", mode)

    def copy(self) -> "_Compress":
        c = _Compress.__new__(_Compress)
        c._d = self._d.copy()
        return c


class _Decompress:
    """zlib.decompressobj-compatible wrapper over stream.api.Inflate."""

    def __init__(self, wbits, zdict):
        self._i = Inflate(wbits=wbits, dictionary=zdict)
        self._pending = bytearray()   # decoded but not yet handed out
        self.unconsumed_tail = b""

    @property
    def eof(self) -> bool:
        return self._i.eof and not self._pending

    @property
    def unused_data(self) -> bytes:
        return bytes(getattr(self._i, "unused_data", b""))

    def decompress(self, data, max_length: int = 0) -> bytes:
        data = self.unconsumed_tail + bytes(data)
        self.unconsumed_tail = b""
        if max_length and len(self._pending) >= max_length:
            # output budget already satisfied: hold the input back whole
            self.unconsumed_tail = data
            out = bytes(self._pending[:max_length])
            del self._pending[:max_length]
            return out
        self._pending += self._i.decompress(data)
        if max_length and len(self._pending) > max_length:
            out = bytes(self._pending[:max_length])
            del self._pending[:max_length]
            return out
        out = bytes(self._pending)
        del self._pending[:]
        return out

    def flush(self, length: int = DEF_BUF_SIZE) -> bytes:
        # stdlib zlib returns remaining output and does NOT raise on a
        # truncated stream here (measured against CPython's zlib)
        out = bytes(self._pending)
        del self._pending[:]
        return out

    def copy(self) -> "_Decompress":
        c = _Decompress.__new__(_Decompress)
        c._i = self._i.copy()
        c._pending = bytearray(self._pending)
        c.unconsumed_tail = self.unconsumed_tail
        return c


def compressobj(level: int = Z_DEFAULT_COMPRESSION, method: int = DEFLATED,
                wbits: int = MAX_WBITS, memLevel: int = DEF_MEM_LEVEL,
                strategy: int = Z_DEFAULT_STRATEGY,
                zdict: bytes | None = None) -> _Compress:
    return _Compress(level, method, wbits, memLevel, strategy, zdict)


def decompressobj(wbits: int = MAX_WBITS,
                  zdict: bytes | None = None) -> _Decompress:
    return _Decompress(wbits, zdict)
