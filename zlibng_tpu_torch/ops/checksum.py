"""Device checksums: Adler-32 and CRC-32 of a buffer on the card.

Counterpart of `zlibng_tpu/ops/checksum_jax.py` (zlib-ng's SIMD checksum
families, adler32_avx2.c and crc32_pclmulqdq/braid, as array code):

  adler32: per-chunk (sum, weighted-sum) reductions and an exact merge;
           the leading zero padding only adds its length to s2, which the
           host takes off again.
  crc32:   every chunk's CRC at once, as the XOR of one table entry per
           byte (the byte's CRC_TABLE value advanced by the zero bytes after
           it in its chunk: the slicing-by-8 tables CRC_TABLES, extended to
           the whole chunk), then a log-depth GF(2) tree combine across
           chunks with crc32_combine operators. The zero padding goes in front
           of the data, and its CRC advanced past the data is XORed out.

The reference spends 32 conditional XORs per word on the CRC because TPU
gathers are slow; a GPU gathers well, and the result is the same int. Both
run in int64 (exact: every intermediate stays below 2**40).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..checksum.adler32 import adler32_combine
from ..checksum.crc32 import _gf2_matrix_times, _shift_operator, crc32_combine
from ..format.constants import ADLER_BASE, CRC_TABLE
from .deflate import _device

# chunk length for both checksums (bytes); a power of two, multiple of 8
CHUNK = 1024
_BASE = ADLER_BASE


def _as_bytes(data, dev: torch.device) -> torch.Tensor:
    """`data` (bytes-like, uint8 ndarray or uint8 tensor) as a flat uint8
    tensor on `dev`."""
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).to(device=dev, dtype=torch.uint8)
    arr = np.array(memoryview(data) if not isinstance(data, np.ndarray)
                   else data, dtype=np.uint8, copy=True).reshape(-1)
    return torch.from_numpy(arr).to(dev)


def _padded(buf: torch.Tensor, chunks: int) -> torch.Tensor:
    """buf zero-padded in front to (chunks, CHUNK)."""
    out = torch.zeros(chunks * CHUNK, dtype=torch.uint8, device=buf.device)
    out[out.numel() - buf.numel():] = buf
    return out.view(chunks, CHUNK)


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of x along its last axis (a power-of-two length)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


# ---------------------------------------------------------------------------
# adler32
# ---------------------------------------------------------------------------
def _adler32_device(chunks: torch.Tensor) -> int:
    """chunks: (C, CHUNK) uint8 (zero-padded). Returns the Adler-32 of the
    padded stream (s2 << 16 | s1)."""
    C = chunks.shape[0]
    dev = chunks.device
    b = chunks.long()
    csum = b.sum(1) % _BASE                                     # (C,)
    w = CHUNK - torch.arange(CHUNK, dtype=torch.int64, device=dev)
    wsum = (b * w).sum(1) % _BASE
    # chunk c's bytes carry extra weight (the bytes after chunk c) in s2
    offs = torch.arange(C, dtype=torch.int64, device=dev) * CHUNK
    trailing = (C * CHUNK - offs - CHUNK) % _BASE
    t = (wsum + csum * trailing % _BASE) % _BASE
    s1 = (1 + csum.sum()) % _BASE
    s2 = (t.sum() + (C * CHUNK) % _BASE) % _BASE
    s1, s2 = torch.stack([s1, s2]).tolist()
    return (s2 << 16) | s1


def adler32_cuda(data, value: int = 1, device="cuda") -> int:
    """Adler-32 of `data` on `device` (the card unless device="cpu"),
    seeded with `value`; equals zlib.adler32(data, value)."""
    dev = _device(device, "adler32_cuda")
    buf = _as_bytes(data, dev)
    n = buf.numel()
    if n == 0:
        padded_adler, pad = 1, 0
    else:
        c = -(-n // CHUNK)
        pad = c * CHUNK - n
        padded_adler = _adler32_device(_padded(buf, c))
    # unpad: `pad` leading zeros keep s1 at 1 and add 1 to s2 per byte
    s1 = padded_adler & 0xFFFF
    s2 = ((padded_adler >> 16) - pad) % _BASE
    a = (s2 << 16) | s1
    if value != 1:
        return adler32_combine(value, a, n)
    return a


# ---------------------------------------------------------------------------
# crc32
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _chunk_table(dev: str) -> torch.Tensor:
    """(CHUNK * 256,) int64: entry d * 256 + x is CRC_TABLE[x] advanced by
    d zero bytes (rows 0-7 are the slicing-by-8 tables CRC_TABLES)."""
    tab = np.zeros((CHUNK, 256), np.uint64)
    t0 = CRC_TABLE.astype(np.uint64)
    tab[0] = t0
    for d in range(1, CHUNK):
        prev = tab[d - 1]
        tab[d] = t0[prev & np.uint64(0xFF)] ^ (prev >> np.uint64(8))
    return torch.from_numpy(tab.reshape(-1).astype(np.int64)).to(dev)


def _apply_mat(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """GF(2) matrix (32 column vectors, int64) times each entry of v."""
    bit = torch.arange(32, dtype=torch.int64, device=v.device)
    return _xor_fold(mat * ((v[:, None] >> bit) & 1))


def _crc32_device(chunks: torch.Tensor, shift_mats: torch.Tensor,
                  levels: int) -> int:
    """chunks: (C = 2**levels, CHUNK) uint8. Returns the finalized CRC-32
    of the concatenated padded stream."""
    dev = chunks.device
    dist = (CHUNK - 1 - torch.arange(CHUNK, dtype=torch.int64, device=dev))
    tab = _chunk_table(str(dev))
    # register contribution of each chunk from a zero register, then the
    # init/final XORs: crc(A) = L(A) ^ crc(CHUNK zero bytes)
    c = _xor_fold(tab[dist[None, :] * 256 + chunks.long()]) ^ _crc_zeros(CHUNK)
    # log-depth combine: crc(A||B) = M_{|B|}·crc(A) ^ crc(B)
    for k in range(levels):
        c = _apply_mat(shift_mats[k], c[0::2]) ^ c[1::2]
    return int(c[0])


@functools.lru_cache(maxsize=64)
def _combine_matrices(levels: int, dev: str) -> torch.Tensor:
    """Row k: the operator advancing a CRC by CHUNK * 2**k zero bytes."""
    mats = np.zeros((max(levels, 1), 32), np.int64)
    for k in range(levels):
        mats[k] = _shift_operator(CHUNK << k).astype(np.int64)
    return torch.from_numpy(mats).to(dev)


@functools.lru_cache(maxsize=64)
def _crc_zeros(pad: int) -> int:
    """Finalized CRC of `pad` zero bytes: register shift of the init value."""
    return _gf2_matrix_times(_shift_operator(pad), 0xFFFFFFFF) ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=64)
def _pad_term(pad: int, n: int) -> int:
    """M_n·crc(Z): what `pad` leading zero bytes Z add to the CRC of the n
    bytes after them (host GF(2) work, cached for repeated sizes)."""
    return _gf2_matrix_times(_shift_operator(n), _crc_zeros(pad))


def _unpad_crc(crc_padded: int, pad: int, n: int) -> int:
    """crc(A) from the finalized crc(Z || A), Z being `pad` zero bytes and
    n = |A|: crc(Z||A) = M_n·crc(Z) ^ crc(A)."""
    return crc_padded ^ _pad_term(pad, n) if pad else crc_padded


def crc32_cuda(data, value: int = 0, device="cuda") -> int:
    """CRC-32 of `data` on `device` (the card unless device="cpu"), seeded
    with `value`; equals zlib.crc32(data, value)."""
    dev = _device(device, "crc32_cuda")
    buf = _as_bytes(data, dev)
    n = buf.numel()
    if n == 0:
        return value
    c = -(-n // CHUNK)
    c_pow = 1 << (c - 1).bit_length()
    levels = c_pow.bit_length() - 1
    raw = _crc32_device(_padded(buf, c_pow),
                        _combine_matrices(levels, str(dev)), levels)
    crc = _unpad_crc(raw, c_pow * CHUNK - n, n)
    if value != 0:
        return crc32_combine(value, crc, n)
    return crc
