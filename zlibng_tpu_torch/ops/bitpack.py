"""Token bit-field assembly and rendering (counterpart of
`zlibng_tpu/ops/bitpack_jax.py`).

A token's bits (<= 55) are held as two u32 halves (lo, hi) in int64
tensors, so shifts never wrap differently on CPU and CUDA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .lz77 import dist_extra_arith, length_extra_arith

_M32 = 0xFFFFFFFF


def _or_field(lo: torch.Tensor, hi: torch.Tensor, val: torch.Tensor,
              sh: torch.Tensor):
    """(lo, hi) |= val << sh for a 55-bit value held as two u32 halves."""
    val = val.to(torch.int64)
    sh = sh.to(torch.int64)
    lo_part = torch.where(sh < 32, (val << sh.clamp(max=31)) & _M32, 0)
    # hi gets val >> (32 - sh) when 0 < sh < 32, or val << (sh - 32) when
    # sh >= 32
    hi_lowpart = torch.where((sh > 0) & (sh < 32),
                             val >> (32 - sh).clamp(1, 31), 0)
    hi_part = torch.where(sh >= 32, (val << (sh - 32).clamp(0, 31)) & _M32,
                          hi_lowpart)
    return lo | lo_part, hi | hi_part


def render_body_tokens(tok_len, tok_dist, lsym, dsym, sel, lit_lens,
                       lit_codes, dist_lens, dist_codes):
    """Per-position token bits against per-lane code tables (the
    reference's per-lane function, batched over B lanes by gathers instead
    of its one-hot matmuls). tok_len/tok_dist/lsym/dsym/sel: (B, N);
    lit_lens/lit_codes: (B, 288) int32 (codes LSB first); dist_lens/
    dist_codes: (B, 30). Returns (lo, hi) u32 halves in int64 and nbits
    int32, all (B, N) and 0 where not selected."""
    i32 = torch.int32
    is_match = tok_len > 0
    ls = lsym.long()
    code0 = lit_codes.to(torch.int64).gather(1, ls)
    n0 = lit_lens.to(i32).gather(1, ls)
    le, lv = length_extra_arith(tok_len.clamp(min=3))
    le = torch.where(is_match, le, 0)
    lv = torch.where(is_match, lv, 0)
    # distance tables padded to 32 symbols, as the reference's one-hot
    # lookup pads them (symbols 30/31 read code 0, length 0)
    ds = dsym.long()
    dcode = F.pad(dist_codes.to(torch.int64), (0, 2)).gather(1, ds)
    dn = torch.where(is_match, F.pad(dist_lens.to(i32), (0, 2)).gather(1, ds),
                     0)
    de, dv = dist_extra_arith(tok_dist.clamp(min=1))
    de = torch.where(is_match, de, 0)
    dv = torch.where(is_match, dv, 0)

    lo, hi = code0, torch.zeros_like(code0)
    sh = n0
    lo, hi = _or_field(lo, hi, lv, sh)
    sh = sh + le
    lo, hi = _or_field(lo, hi, torch.where(is_match, dcode, 0), sh)
    sh = sh + dn
    lo, hi = _or_field(lo, hi, dv, sh)
    nbits = torch.where(sel, n0 + le + dn + de, 0).to(i32)
    return torch.where(sel, lo, 0), torch.where(sel, hi, 0), nbits

