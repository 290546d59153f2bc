"""Stage-1 LZ77: hash -> candidates -> match extension -> lazy parse.

Counterpart of `zlibng_tpu/ops/lz77_jax.py`, batched over lanes: every
function takes (B, N) lanes, each [history | payload]. u32 words are held
in int64 (values < 2^32) so CPU and CUDA wrap identically; the probe words
handed to K1 are their int32 bit patterns.

  * one stable sort on the hash gives the (hash, pos) order (positions
    start ascending), and the probe planes follow it by gather
  * K1 (ops/probe.py) keeps, per sorted row, the best of its `dense`
    nearest same-hash predecessors; for tuned chains beyond 64, the deep
    probes go on for the rows that still hunt
  * rows whose 16-byte probe matched in full are extended column-wise
  * the dist-1 run prepass, the minimum/too-far filters and the one-step
    lazy rule set each position's step; K2 (ops/parse.py) walks them
"""
from __future__ import annotations

import torch

from ..format.constants import MAX_MATCH, MIN_MATCH, WINDOW_SIZE
from ..lz77.engine import HASH_MULT, TOO_FAR
from .probe import NEG, _ctz_bytes32, probe_best

# probe width in 4-byte words (16-byte probes), as in the reference
PROBE_WORDS = 4
# dense probes (K1) cover every shipped level's chain (<= 64); deeper tuned
# chains run the compacted deep probes on the rows that still hunt
DENSE_PROBES = 64
GOOD_L16 = 12
GATE_DEPTH = 16
# needy rows extended per batch of the wide extension (bounds memory only)
_EXT_ROWS = 1 << 16
# (row, probe) pairs per chunk of the deep probes (bounds memory only)
_DEEP_PAIRS = 1 << 20
# work of the deep probes so far (a run resets it): needy rows, probes per
# row of the last call, chunks
deep_stats = {"rows": 0, "k_steps": 0, "chunks": 0}

_M32 = 0xFFFFFFFF


def _build_w4(pad: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte word at every byte offset of `pad` (..., M)
    uint8, as int64 (..., M - 3)."""
    d = pad.to(torch.int64)
    M = d.shape[-1]
    return (d[..., : M - 3] | (d[..., 1: M - 2] << 8)
            | (d[..., 2: M - 1] << 16) | (d[..., 3:] << 24))


def _hash_w4(w4: torch.Tensor) -> torch.Tensor:
    """16-bit multiplicative hash (w4 * HASH_MULT mod 2^32) >> 16, with the
    product split so no int64 intermediate overflows."""
    lo = w4 * (HASH_MULT & 0xFFFF)
    hi = ((w4 * (HASH_MULT >> 16)) & 0xFFFF) << 16
    return (((lo + hi) & _M32) >> 16).to(torch.int32)


def _as_i32(u32: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bits."""
    return torch.where(u32 >= (1 << 31), u32 - (1 << 32), u32).to(torch.int32)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x >= 1, exact via the f32 exponent (x < 2^24)."""
    _, e = torch.frexp(x.to(torch.float32))
    return (e - 1).to(torch.int32)


def length_code_arith(length: torch.Tensor) -> torch.Tensor:
    """Match length (3..258) -> lit/len symbol (257..285)."""
    l3 = (length - 3).to(torch.int32)
    e = torch.clamp(_floor_log2(torch.clamp(l3, min=1)) - 2, min=0)
    code_hi = 257 + ((e + 1) << 2) + ((l3 >> e) & 3)
    code = torch.where(l3 < 8, 257 + l3, code_hi)
    return torch.where(length == 258, 285, code).to(torch.int32)


def dist_code_arith(dist: torch.Tensor) -> torch.Tensor:
    """Distance (1..32768) -> distance symbol (0..29)."""
    d1 = (dist - 1).to(torch.int32)
    e = torch.clamp(_floor_log2(torch.clamp(d1, min=1)) - 1, min=0)
    code_hi = ((e + 1) << 1) + ((d1 >> e) & 1)
    return torch.where(d1 < 4, d1, code_hi).to(torch.int32)


def length_extra_arith(length: torch.Tensor):
    """(extra_nbits, extra_value) of a match length."""
    l3 = (length - 3).to(torch.int32)
    e = torch.clamp(_floor_log2(torch.clamp(l3, min=1)) - 2, min=0)
    e = torch.where(l3 < 8, 0, e)
    e = torch.where(length == 258, 0, e)
    val = torch.where(length == 258, 0, l3 & ((1 << e) - 1))
    return e.to(torch.int32), val.to(torch.int32)


def dist_extra_arith(dist: torch.Tensor):
    """(extra_nbits, extra_value) of a match distance."""
    d1 = (dist - 1).to(torch.int32)
    e = torch.clamp(_floor_log2(torch.clamp(d1, min=1)) - 1, min=0)
    e = torch.where(d1 < 4, 0, e)
    return e.to(torch.int32), (d1 & ((1 << e) - 1)).to(torch.int32)


def sorted_probe_rows(w4: torch.Tensor, N: int):
    """(hash, pos)-sorted probe inputs of K1 from the lanes' words.
    Returns (w2_s (B, N, W) int32, h_sorted (B, N) int32, pos_s (B, N)
    int32, order (B, N) int64)."""
    B = w4.shape[0]
    W = PROBE_WORDS
    h = _hash_w4(w4[:, :N])
    h_sorted, order = torch.sort(h, dim=1, stable=True)
    w2 = torch.stack([w4[:, 4 * i: N + 4 * i] for i in range(W)], dim=2)
    w2_s = _as_i32(torch.gather(w2, 1, order[..., None].expand(B, N, W)))
    return w2_s.contiguous(), h_sorted.contiguous(), \
        order.to(torch.int32), order


def _wide_extension(w4, need, best_cand, CX: int):
    """Exact match length of the needy rows: 4 * (first differing column)
    + leading equal bytes of that column's xor word (4 * CX + 4 when all
    CX columns agree), as lz77_jax.py's batched wide_body computes it."""
    bi, pi = need.nonzero(as_tuple=True)
    cols = 4 * torch.arange(CX, dtype=torch.int64, device=w4.device)
    out = torch.empty(bi.shape[0], dtype=torch.int32, device=w4.device)
    for lo in range(0, bi.shape[0], _EXT_ROWS):
        b = bi[lo: lo + _EXT_ROWS, None]
        p = pi[lo: lo + _EXT_ROWS, None]
        c = best_cand[b, p].long()
        X = w4[b, p + cols] ^ w4[b, c + cols]                  # (M, CX)
        nzcol = torch.where(X != 0, torch.arange(CX, device=w4.device), CX)
        fc = nzcol.min(1).values
        word = torch.where(fc < CX,
                           X.gather(1, fc.clamp(max=CX - 1)[:, None])[:, 0],
                           0)
        out[lo: lo + _EXT_ROWS] = (4 * fc + _ctz_bytes32(word)).to(torch.int32)
    return bi, pi, out


def deep_probes(w2_s, h_sorted, pos_s, hv, best_score, best_cand_s,
                enc_start: int, enc_end, dense: int, chain: int, good: int,
                max_dist: int = WINDOW_SIZE) -> None:
    """The compacted deep probes k = dense+1..chain (lz77_jax.py:255-312)
    after K1's dense sweep, on K1's inputs and its (B, N) results, which
    they update in place. Only rows that still hunt (best l16 < good),
    can emit (enc_start <= pos < enc_end (B, 1)) and have a (dense+1)-th
    same-hash predecessor (same-hash runs are contiguous) are probed.
    Every probe of a row is scored at once; the best replaces the row's
    best only if strictly greater, as k-by-k strict updates would:
    distinct candidates of a row never tie on a valid score (l16 << 20
    dominates any dist)."""
    W = w2_s.shape[2]
    dev = w2_s.device
    kd = dense + 1
    has_deeper = torch.zeros_like(h_sorted, dtype=torch.bool)
    has_deeper[:, kd:] = h_sorted[:, kd:] == h_sorted[:, :-kd]
    cur_l16 = torch.where(best_score > NEG,
                          (best_score + (pos_s - best_cand_s)) >> 20, 0)
    need = (has_deeper & (cur_l16 < max(4, min(good, 16)))
            & (pos_s >= enc_start) & (pos_s < enc_end))
    bi, si = need.nonzero(as_tuple=True)
    ks = torch.arange(kd, chain + 1, dtype=torch.int64, device=dev)
    rows = max(1, _DEEP_PAIRS // ks.numel())
    deep_stats["rows"] += int(bi.numel())
    deep_stats["k_steps"] = int(ks.numel())
    deep_stats["chunks"] += -(-int(bi.numel()) // rows)
    for lo in range(0, bi.numel(), rows):
        b = bi[lo: lo + rows, None]
        s = si[lo: lo + rows, None]
        cidx = (s - ks).clamp(min=0)                            # (M, K)
        x = w2_s[b, s] ^ w2_s[b, cidx]                          # (M, K, W)
        l16 = _ctz_bytes32(x[..., W - 1])
        for w in range(W - 2, -1, -1):
            l16 = torch.where(x[..., w] != 0, _ctz_bytes32(x[..., w]),
                              4 + l16)
        cpos = pos_s[b, cidx]
        dist = pos_s[b, s] - cpos
        ok = ((h_sorted[b, s] == h_sorted[b, cidx]) & (cpos >= hv[b])
              & (dist <= max_dist) & (dist > 0) & (s >= ks))
        score = torch.where(ok, (l16 << 20) - dist, NEG)
        top, arg = score.max(1)
        b, s = b[:, 0], s[:, 0]
        better = top > best_score[b, s]
        best_score[b, s] = torch.where(better, top, best_score[b, s])
        best_cand_s[b, s] = torch.where(
            better, cpos.gather(1, arg[:, None])[:, 0], best_cand_s[b, s])


def lz77_lane(data: torch.Tensor, enc_start: int, enc_end: torch.Tensor,
              hist_valid_from: torch.Tensor, chain: int, lazy: bool,
              max_lazy: int, nice: int = 258, unit: int = 0,
              strategy: int = 0, good: int = GOOD_L16,
              max_dist: int = WINDOW_SIZE) -> dict:
    """data: (B, N) uint8 lanes; enc_start: int; enc_end, hist_valid_from:
    (B,) int32. unit > 0 caps matches at `unit`-byte boundaries past
    enc_start. Returns (B, N) step/take/blen/bdist, as lz77_jax.lz77_lane
    returns per lane.

    strategy: Z_HUFFMAN_ONLY (2) emits literals only; Z_RLE (3) matches
    only the distance-1 run prepass; Z_FILTERED (1) drops matches shorter
    than 6 (zlib-ng deflate.c:1036-1043 dispatch)."""
    if strategy not in (0, 1, 2, 3):
        raise ValueError(f"lz77_lane: strategy {strategy} (Z_FIXED parses "
                         "as strategy 0)")
    use_probes = strategy not in (2, 3)
    use_runs = strategy != 2
    min_keep = 6 if strategy == 1 else MIN_MATCH

    B, N = data.shape
    dev = data.device
    I32 = torch.int32
    pos = torch.arange(N, dtype=I32, device=dev)
    enc_end = enc_end.to(I32).reshape(B, 1)
    hv = hist_valid_from.to(I32).reshape(B, 1)
    n_ext = min(nice, MAX_MATCH)
    CX = (n_ext + 3) // 4 + 1
    pad = torch.cat([data, torch.zeros((B, 4 * CX + 12), dtype=torch.uint8,
                                       device=dev)], dim=1)
    w4 = _build_w4(pad)                      # (B, N + 4*CX + 9)

    if use_probes:
        w2_s, h_sorted, pos_s, order = sorted_probe_rows(w4, N)
        dense = min(chain, DENSE_PROBES)
        good_l16 = max(4, min(good, 4 * PROBE_WORDS))
        hv_b = hist_valid_from.to(I32).contiguous()
        best_score, best_cand_s = probe_best(
            w2_s, h_sorted, pos_s, hv_b, dense, GATE_DEPTH, good_l16,
            max_dist=max_dist)
        if chain > dense:
            deep_probes(w2_s, h_sorted, pos_s, hv_b, best_score,
                        best_cand_s, enc_start, enc_end, dense, chain, good,
                        max_dist)
        # pack (valid, l16, cand) and scatter back to position order
        pos_bits = max(17, (N - 1).bit_length())
        valid_s = best_score > NEG
        l16_s = (best_score + (pos_s - best_cand_s)) >> 20
        packed_s = torch.where(valid_s, (l16_s << pos_bits) | best_cand_s, -1)
        packed = torch.empty_like(packed_s).scatter_(1, order, packed_s)
        has_cand = packed >= 0
        best_cand = torch.where(has_cand, packed & ((1 << pos_bits) - 1), 0)
        l16 = torch.where(has_cand, packed >> pos_bits, 0)
        best_dist = torch.where(has_cand, pos - best_cand, 0)
    else:
        has_cand = torch.zeros((B, N), dtype=torch.bool, device=dev)
        best_cand = torch.zeros((B, N), dtype=I32, device=dev)
        l16 = torch.zeros((B, N), dtype=I32, device=dev)
        best_dist = torch.zeros((B, N), dtype=I32, device=dev)

    # ---- extension: the 16-byte probe is exact unless it matched in full
    N_PROBE = 4 * PROBE_WORDS
    ext = l16
    if n_ext > N_PROBE and use_probes:
        need = (has_cand & (l16 >= N_PROBE) & (pos >= enc_start)
                & (pos < enc_end))
        bi, pi, ext_c = _wide_extension(w4, need, best_cand, CX)
        ext = l16.clone()
        ext[bi, pi] = ext_c
    cap = torch.clamp(enc_end - pos, max=MAX_MATCH)
    if unit > 0:  # stop at the next unit boundary (block-choice granule)
        cap = torch.minimum(cap, unit - ((pos - enc_start) % unit))
    blen = torch.minimum(torch.clamp(ext, max=n_ext), cap)
    blen = torch.where(has_cand, blen, 0)

    # ---- dist-1 run prepass: distance to the next inequality
    if use_runs:
        eq = torch.cat([data[:, 1:] == data[:, :-1],
                        torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1)
        falses = torch.where(~eq, pos, N)
        next_false = falses.flip(1).cummin(1).values.flip(1)
        run_pairs = next_false - pos
        prev_eq = torch.cat([torch.zeros((B, 1), dtype=torch.bool,
                                         device=dev), eq[:, :-1]], 1)
        run_ok = prev_eq & (pos - 1 >= hv)
        run_len = torch.where(run_ok, 1 + run_pairs, 0)
        run_len = torch.minimum(torch.clamp(run_len, max=MAX_MATCH), cap)
        use_run = run_len > blen
        blen = torch.where(use_run, run_len, blen)
        best_dist = torch.where(use_run, 1, best_dist)

    # ---- minimum / too-far filters
    ok = (blen >= min_keep) & ~((blen == MIN_MATCH) & (best_dist > TOO_FAR))
    blen = torch.where(ok, blen, 0).to(I32)
    best_dist = torch.where(ok, best_dist, 0).to(I32)

    # ---- lazy decision (deflate_slow one-step rule)
    if lazy:
        nxt_len = torch.cat([blen[:, 1:], torch.zeros_like(blen[:, :1])], 1)
        defer = (nxt_len > blen) & (blen < max_lazy)
    else:
        defer = torch.zeros_like(blen, dtype=torch.bool)
    take = (blen >= MIN_MATCH) & ~defer
    step = torch.where(take, blen, 1).to(I32)
    return dict(step=step, take=take, blen=blen, bdist=best_dist)


def finalize_tokens(lanes: torch.Tensor, outs: dict,
                    sel: torch.Tensor) -> dict:
    """Token arrays once the parse mask is known. lanes: (B, N) uint8."""
    is_match = sel & outs["take"] & (outs["blen"] > 0)
    tok_len = torch.where(is_match, outs["blen"], 0)
    tok_dist = torch.where(is_match, outs["bdist"], 0)
    lsym = torch.where(is_match,
                       length_code_arith(torch.clamp(tok_len, min=3)),
                       lanes.to(torch.int32))
    dsym = torch.where(is_match,
                       dist_code_arith(torch.clamp(tok_dist, min=1)), 0)
    return dict(sel=sel, tok_len=tok_len, tok_dist=tok_dist,
                lsym=lsym, dsym=dsym)


def _hist_rows(sym: torch.Tensor, w: torch.Tensor, bins: int) -> torch.Tensor:
    """Weighted histogram of every row of `sym` (R, T) into `bins` bins."""
    R = sym.shape[0]
    rows = torch.arange(R, dtype=torch.int64, device=sym.device)[:, None]
    flat = (rows * bins + sym.long()).reshape(-1)
    out = torch.zeros(R * bins, dtype=torch.int32, device=sym.device)
    out.index_add_(0, flat, w.to(torch.int32).reshape(-1))
    return out.reshape(R, bins)


def unit_freqs(lsym, dsym, sel, is_match, hist: int, unit: int, q: int):
    """Per-unit token histograms over (B, N) lanes: units are contiguous
    `unit`-byte ranges of the payload (tokens never cross them). Returns
    (B, q, 286) and (B, q, 30) int32."""
    B = lsym.shape[0]
    lsq = lsym[:, hist:].reshape(B * q, unit)
    dsq = dsym[:, hist:].reshape(B * q, unit)
    seq = sel[:, hist:].reshape(B * q, unit)
    imq = (sel & is_match)[:, hist:].reshape(B * q, unit)
    lfreq = _hist_rows(lsq, seq, 286).reshape(B, q, 286)
    dfreq = _hist_rows(dsq, imq, 30).reshape(B, q, 30)
    return lfreq, dfreq
