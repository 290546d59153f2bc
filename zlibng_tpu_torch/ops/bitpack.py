"""Token bit-field assembly (counterpart of `zlibng_tpu/ops/bitpack_jax.py`).

A token's bits (<= 55) are held as two u32 halves (lo, hi) in int64
tensors, so shifts never wrap differently on CPU and CUDA.
"""
from __future__ import annotations

import torch

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
