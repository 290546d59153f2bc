"""Bit packing of token rows into LSB-first byte streams, batched over
rows (counterpart of `zlibng_tpu/ops/bitpack_merge.py`).

`pack_rows` is the pack of every compress route: on CUDA tensors one
launch of the hand-written kernel `csrc/bitpack.cu`, one block per row; on
CPU tensors `hierarchical_pack`, the plain version, which stays its
readable twin: every token is a little-endian string of two u32 limbs;
strings are concatenated pairwise within windows of 128 tokens (limb caps
<= 256), the window strings are unpacked to bytes, shifted to their global
bit phase and OR-placed into the output. u32 limbs are held in int64
tensors.
"""
from __future__ import annotations

import torch

from .. import _build

WINDOW = 128         # tokens merged pairwise per window
_M32 = 0xFFFFFFFF
_MAX_T = 1 << 25     # tokens a row: its bits (<= 64 each) fit an int32

# `launches`: bitpack kernel launches so far (`_build.launches`)
__getattr__ = _build.launch_count("bitpack")


def pack_rows(lo: torch.Tensor, hi: torch.Tensor, nbits: torch.Tensor,
              out_bytes: int):
    """Pack (R, T) token rows (lo, hi u32 halves in int64; nbits int32 in
    [0, 63]) into R LSB-first byte streams, each cut to out_bytes bytes
    and zero-filled after its end. Returns (bytes (R, out_bytes) uint8,
    total_bits (R,) int32: each stream's whole length, also where it
    overflows out_bytes). CUDA tensors: one launch of the kernel
    `csrc/bitpack.cu` on the current stream (or it raises); CPU tensors:
    the plain version, `hierarchical_pack`; any other device raises. The
    two are equal byte for byte."""
    if nbits.is_cuda:
        return _pack_rows_cuda(lo, hi, nbits, out_bytes)
    if nbits.device.type != "cpu":
        raise ValueError(f"pack_rows: unsupported device {nbits.device}")
    return hierarchical_pack(lo, hi, nbits, out_bytes)


def _pack_rows_cuda(lo: torch.Tensor, hi: torch.Tensor, nbits: torch.Tensor,
                    out_bytes: int):
    """Runs the kernel on CUDA tensors, read as they are (lo and hi int64,
    nbits int32, no cast): one launch, checking only what needs no wait
    for the card."""
    if nbits.dim() != 2 or lo.shape != nbits.shape or hi.shape != nbits.shape:
        raise ValueError("bitpack kernel: lo, hi and nbits must be (R, T) "
                         "alike")
    R, T = nbits.shape
    if not 0 <= out_bytes < 1 << 31 or T > _MAX_T or R >= 1 << 31:
        raise ValueError(f"bitpack kernel: {R} rows of {T} tokens into "
                         f"{out_bytes} bytes; it takes out_bytes in "
                         f"[0, 2^31), T <= 2^25 and R < 2^31")
    dev = _build.check_cuda("bitpack kernel", lo, hi, dtype=torch.int64)
    _build.check_cuda("bitpack kernel", nbits, dev=dev)
    out = torch.empty((R, out_bytes), dtype=torch.uint8, device=dev)
    total = torch.empty(R, dtype=torch.int32, device=dev)
    if R:
        _build.launch("bitpack", dev, lo, hi, nbits, out, total, R, T,
                      out_bytes)
    return out, total


def _bitshift_limbs(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Shift each row's LSB-first limb string (..., L) left by r (0..31)."""
    rr = r.to(torch.int64)[..., None]
    lo = torch.where(rr > 0, (rows << rr) & _M32, rows)
    carry_in = torch.cat([torch.zeros_like(rows[..., :1]), rows[..., :-1]], -1)
    hi = torch.where(rr > 0, carry_in >> (32 - rr), 0)
    return lo | hi


def _limbshift_rows(rows: torch.Tensor, nlimbs: torch.Tensor,
                    max_shift: int) -> torch.Tensor:
    """Shift each row toward higher limbs by nlimbs (0..max_shift), by
    conditional static shifts (log2 passes)."""
    out = rows
    shift = nlimbs.to(torch.int64)
    k = 1
    while k <= max_shift:
        use = ((shift & k) > 0)[..., None]
        shifted = torch.cat([torch.zeros_like(out[..., :k]), out[..., :-k]],
                            -1)
        out = torch.where(use, shifted, out)
        k <<= 1
    return out


def _limbs_to_bytes(rows: torch.Tensor) -> torch.Tensor:
    """(..., L) u32 limbs -> (..., 4L) uint8 bytes, little-endian."""
    b = torch.stack([(rows >> (8 * k)) & 0xFF for k in range(4)], -1)
    return b.reshape(*rows.shape[:-1], 4 * rows.shape[-1]).to(torch.uint8)


def _bitshift_bytes(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Shift each row's LSB-first byte string (..., L) left by r (0..7)."""
    rw = rows.to(torch.int32)
    rr = r.to(torch.int32)[..., None]
    lo = (rw << rr) & 0xFF
    carry_in = torch.cat([torch.zeros_like(rw[..., :1]), rw[..., :-1]], -1)
    hi = torch.where(rr > 0, carry_in >> (8 - rr), 0)
    return (lo | hi).to(torch.uint8)


def hierarchical_pack(lo: torch.Tensor, hi: torch.Tensor,
                      nbits: torch.Tensor, out_bytes: int):
    """Pack (R, T) token arrays (lo, hi u32 halves in int64; nbits int32)
    into R LSB-first byte streams. Returns (bytes (R, out_bytes) uint8,
    total_bits (R,) int32)."""
    R, T = nbits.shape
    Tp = 1 << (T - 1).bit_length()
    if Tp != T:
        z = torch.zeros((R, Tp - T), dtype=torch.int64, device=lo.device)
        lo = torch.cat([lo.to(torch.int64), z], 1)
        hi = torch.cat([hi.to(torch.int64), z], 1)
        nbits = torch.cat([nbits, z.to(nbits.dtype)], 1)
        T = Tp
    # strip any bits at/above nbits (the merge ORs strings together)
    nb_lo = nbits.clamp(0, 32).to(torch.int64)
    nb_hi = (nbits - 32).clamp(0, 31).to(torch.int64)
    lo = lo.to(torch.int64)
    lo = torch.where(nb_lo >= 32, lo, lo & ((1 << nb_lo) - 1))
    hi = hi.to(torch.int64) & ((1 << nb_hi) - 1)

    rows = torch.stack([lo, hi], -1)                    # (R, T, 2)
    lens = nbits.to(torch.int32)
    cap = 2
    while rows.shape[1] > max(1, T // WINDOW):
        a, b = rows[:, 0::2], rows[:, 1::2]
        la, lb = lens[:, 0::2], lens[:, 1::2]
        new_cap = cap * 2
        pad = torch.zeros_like(a)
        sb = _bitshift_limbs(torch.cat([b, pad], -1), la & 31)
        sb = _limbshift_rows(sb, la >> 5, max_shift=new_cap // 2)
        rows = torch.cat([a, pad], -1) | sb
        lens = la + lb
        cap = new_cap

    byte_rows = _limbs_to_bytes(rows)                   # (R, Wn, 4*cap)
    if rows.shape[1] == 1:
        out = byte_rows[:, 0]
        if out.shape[1] < out_bytes:
            out = torch.cat([out, torch.zeros(
                (R, out_bytes - out.shape[1]), dtype=torch.uint8,
                device=out.device)], 1)
        return out[:, :out_bytes], lens[:, 0]
    return _place_windows(byte_rows, lens, out_bytes)


def _place_windows(rows: torch.Tensor, lens: torch.Tensor, out_bytes: int):
    """OR-place (R, Wn, cap) window byte rows of bit lengths `lens` into one
    stream per row. Each window is shifted to its global intra-byte phase
    and ORed in at its byte start, clamped like a dynamic slice so a window
    always fits (only an overflowing row, redone by the caller, clamps).
    Returns (bytes (R, out_bytes) uint8, total_bits (R,) int32)."""
    R, Wn, cap = rows.shape
    dev = rows.device
    ends = torch.cumsum(lens, 1).to(torch.int32)
    starts = ends - lens
    total = ends[:, -1]
    rows = torch.cat([rows, torch.zeros((R, Wn, 1), dtype=torch.uint8,
                                        device=dev)], -1)
    rows = _bitshift_bytes(rows, starts & 7)
    cap += 1
    bs = (starts >> 3).clamp(0, out_bytes).long()
    acc = torch.zeros((R, out_bytes + cap), dtype=torch.uint8, device=dev)
    span = torch.arange(cap, device=dev)
    for w in range(Wn):
        idx = bs[:, w: w + 1] + span
        acc.scatter_(1, idx, acc.gather(1, idx) | rows[:, w])
    return acc[:, :out_bytes], total
