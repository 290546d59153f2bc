"""Token bit-field assembly and rendering (counterpart of
`zlibng_tpu/ops/bitpack_jax.py`), and the device copies of the constant
code tables every compress route reads.

A token's bits (<= 55) are held as two u32 halves (lo, hi) in int64
tensors, so shifts never wrap differently on CPU and CUDA.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..format.constants import (
    BL_ORDER, DIST_BASE, DIST_EXTRA, FIXED_DIST_CODES_REV,
    FIXED_DIST_LENGTHS, FIXED_LIT_CODES_REV, FIXED_LIT_LENGTHS, LENGTH_BASE,
    LENGTH_EXTRA, REP_3_6, REPZ_3_10, REPZ_11_138,
)
from ..trace import upload
from .lz77 import (
    dist_code_arith, dist_extra_arith, length_code_arith, length_extra_arith,
)

I32 = torch.int32
_M32 = 0xFFFFFFFF

# extra bits of each literal/length symbol (0 below 257) and distance symbol
LEXT = np.zeros(286, np.int32)
LEXT[257:286] = LENGTH_EXTRA[:29]
DEXT = DIST_EXTRA[:30].astype(np.int32)
# extra bits of each code-length symbol (the dynamic header's repeat codes)
_CL_EXTRA = np.zeros(19, np.int32)
_CL_EXTRA[[REP_3_6, REPZ_3_10, REPZ_11_138]] = (2, 3, 7)

_TABLES = dict(
    lext=LEXT, dext=DEXT,
    fll=FIXED_LIT_LENGTHS[:286].astype(np.int32),
    fl288=FIXED_LIT_LENGTHS.astype(np.int32),
    flc=FIXED_LIT_CODES_REV.astype(np.int32),
    fdl=FIXED_DIST_LENGTHS.astype(np.int32),
    fdc=FIXED_DIST_CODES_REV.astype(np.int32),
    lbase=LENGTH_BASE.astype(np.int32), dbase=DIST_BASE.astype(np.int32),
    bl_order=BL_ORDER.astype(np.int64), cl_extra=_CL_EXTRA,
)


def code_tables(dev) -> dict:
    """The constant code tables on `dev`, uploaded at their first use there
    and shared by every later call (callers must not write to them):
    `lext`/`dext` extra bits, the static code's lengths (`fll` over 286
    symbols, `fl288`, `fdl`) and LSB-first codes (`flc`, `fdc`), decode's
    `lbase`/`dbase`, and the dynamic header's `bl_order` and `cl_extra`."""
    return _code_tables(str(dev))


@functools.lru_cache(maxsize=8)
def _code_tables(dev: str) -> dict:
    return {k: upload(v, torch.device(dev)) for k, v in _TABLES.items()}


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


def render_tokens(lits, tok_len, tok_dist, sel, lit_lens, lit_codes,
                  dist_lens, dist_codes, demote: bool = False):
    """The token render of every compress route: (R, N) rows of tokens
    against code tables, one row each ((R, 288) and (R, 30)) or one for
    all ((288,) and (30,)); codes LSB first. lits: the byte at each
    position; tok_len/tok_dist: a selected match's length and distance
    where tok_len > 0; sel: the selected positions. With `demote`, the
    cost-model demotion first turns a selected match whose bits exceed its
    span's literal bits into literals, unless a byte of the span has no
    code (stage 2 at L2-L9 and Z_FIXED); without it every match is
    emitted (L1, as deflate_quick.c:47-130 does, and the sharded steps).
    Returns (lo, hi) u32 halves in int64 and nbits int32, all (R, N) and
    0 where not selected."""
    tl = tok_len.to(I32)
    td = tok_dist.to(I32)
    R, N = tl.shape
    lt, lc, dt, dc = (t.expand(R, -1) for t in (lit_lens, lit_codes,
                                                 dist_lens, dist_codes))
    is_match = (tl > 0) & sel
    lsm = torch.where(is_match, length_code_arith(tl.clamp(min=3)), 257)
    dsm = torch.where(is_match, dist_code_arith(td.clamp(min=1)), 0)
    le_, lv_ = length_extra_arith(tl.clamp(min=3))
    de_, dv_ = dist_extra_arith(td.clamp(min=1))
    lb, lsm, dsm = lits.long(), lsm.long(), dsm.long()
    lit_code, lit_len = lc.gather(1, lb), lt.gather(1, lb)
    m_code, m_len = lc.gather(1, lsm), lt.gather(1, lsm)
    d_code, d_len = dc.gather(1, dsm), dt.gather(1, dsm)

    if demote:
        pos = torch.arange(N, dtype=I32, device=tl.device)
        match_bits = m_len + le_ + d_len + de_
        csum = torch.cumsum(torch.stack([lit_len, (lit_len == 0).to(I32)],
                                        -1), 1).to(I32)
        csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], 1)
        endq = (pos + tl).clamp(0, N).long()
        at_end = csum.gather(1, endq[..., None].expand(R, N, 2))
        span_bits = at_end[..., 0] - csum[:, :-1, 0]
        span_zero = (at_end[..., 1] - csum[:, :-1, 1]) > 0
        demoted = is_match & ~span_zero & (match_bits > span_bits)
        end_max = torch.where(demoted, pos + tl, 0).cummax(1).values
        covered = pos < end_max
        sel = sel | covered
        is_match = is_match & ~covered

    code0 = torch.where(is_match, m_code, lit_code).to(torch.int64)
    n0 = torch.where(is_match, m_len, lit_len)
    le = torch.where(is_match, le_, 0)
    dn = torch.where(is_match, d_len, 0)
    de = torch.where(is_match, de_, 0)
    lo, hi = code0, torch.zeros_like(code0)
    sh = n0
    lo, hi = _or_field(lo, hi, torch.where(is_match, lv_, 0), sh)
    sh = sh + le
    lo, hi = _or_field(lo, hi, torch.where(is_match, d_code, 0), sh)
    sh = sh + dn
    lo, hi = _or_field(lo, hi, torch.where(is_match, dv_, 0), sh)
    nbits = torch.where(sel, n0 + le + dn + de, 0).to(I32)
    return torch.where(sel, lo, 0), torch.where(sel, hi, 0), nbits


def render_body_tokens(tok_len, tok_dist, lsym, dsym, sel, lit_lens,
                       lit_codes, dist_lens, dist_codes):
    """Per-position token bits against per-lane code tables, the
    reference's per-lane function batched over B lanes: `render_tokens`
    without demotion. tok_len/tok_dist/lsym/dsym/sel: (B, N), as
    `lz77.finalize_tokens` makes them (lsym is a literal's byte, and a
    match's symbols follow from tok_len and tok_dist, so dsym is not
    read); lit_lens/lit_codes: (B, 288); dist_lens/dist_codes: (B, 30)."""
    return render_tokens(lsym, tok_len, tok_dist, sel, lit_lens, lit_codes,
                         dist_lens, dist_codes)
