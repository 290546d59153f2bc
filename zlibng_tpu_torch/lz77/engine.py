"""LZ77 match engine of the host encoder, in numpy: a copy of
`zlibng_tpu/lz77/engine.py`.

  hash      : every position hashed at once, (val * 2654435761) >> 16
              (zlib-ng insert_string.c:13-15)
  candidates: positions sorted by (hash, pos); the K preceding entries of a
              position's hash bucket are its K most recent chain
              predecessors
  extend    : 16-byte prefix probe of every candidate, then 8-byte
              extension of the winner
  parse     : greedy/lazy selection as a jump function over positions,
              walked by pointer doubling (deflate_slow's one-step lazy rule)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..format.constants import MAX_MATCH, MIN_MATCH, WINDOW_SIZE

HASH_MULT = 2654435761   # 4-byte multiplicative hash (Knuth), kept mod 2^32
TOO_FAR = 4096  # emit literal instead of len-3 match beyond this (deflate.h analog)


@dataclass(frozen=True)
class MatchConfig:
    """Per-level tuning (configuration_table analog, deflate.c:142-168)."""
    chain: int = 4          # K candidates per position (max_chain analog)
    lazy: bool = True       # defer to next position if its match is longer
    max_lazy: int = 16      # take immediately at/above this length
    nice: int = 128         # stop extension at this length
    max_len: int = MAX_MATCH


def hash4(data: np.ndarray) -> np.ndarray:
    """16-bit multiplicative hash of the 4 bytes at each position of data
    (N,) uint8, as (N,) int32; the last 3 positions hash to 0."""
    if data.shape[0] < 4:
        return np.zeros(data.shape[0], np.int32)
    d = data.astype(np.uint32)
    v4 = d[:-3] | (d[1:-2] << 8) | (d[2:-1] << 16) | (d[3:] << 24)
    h = ((v4 * np.uint32(HASH_MULT)) & np.uint32(0xFFFFFFFF)) \
        >> np.uint32(16)
    return np.concatenate([h, np.zeros(3, np.uint32)]).astype(np.int32)


def candidates_by_sort(h: np.ndarray, K: int,
                       window: int = WINDOW_SIZE) -> np.ndarray:
    """(N, K) int32 K most recent previous positions with the same hash
    within `window`, -1 where none: the prev[] chain K deep, by one sort."""
    N = h.shape[0]
    key = h.astype(np.int64) * N + np.arange(N, dtype=np.int64)
    order = np.argsort(key)                      # (N,) positions, hash-major
    h_sorted = h[order]
    pos = np.arange(N)
    cands = np.full((N, K), -1, dtype=np.int32)
    for k in range(1, K + 1):
        shifted = np.empty(N, dtype=np.int64)
        shifted[k:] = order[:-k]
        shifted[:k] = -1
        same = np.empty(N, dtype=bool)
        same[k:] = h_sorted[k:] == h_sorted[:-k]
        same[:k] = False
        cand_sorted = np.where(same, shifted, -1)
        cands[order, k - 1] = cand_sorted.astype(np.int32)
    dist = pos[:, None] - cands
    return np.where((cands >= 0) & (dist <= window), cands, -1)


def _build_w8(pad: np.ndarray) -> np.ndarray:
    """Unaligned 8-byte little-endian words at every byte offset of pad."""
    d = pad.astype(np.uint64)
    w = d[:-7].copy()
    for k in range(1, 8):
        w |= d[k:k + d.size - 7] << np.uint64(8 * k)
    return w


def _ctz_bytes(x: np.ndarray) -> np.ndarray:
    """Leading equal bytes (0..8) from an xor of 8-byte words: trailing
    zero bits / 8, exact via the float64 exponent of the lowest set bit."""
    lsb = x & (~x + np.uint64(1))
    e = np.frexp(lsb.astype(np.float64))[1] - 1
    return np.where(x == 0, 8, e >> 3).astype(np.int64)


def find_matches(data: np.ndarray, encode_start: int, encode_end: int,
                 cfg: MatchConfig, window: int = WINDOW_SIZE):
    """Best match (length, dist) per position in [encode_start, encode_end)
    of the lane data (N,) uint8 = [history | payload | slack]: matches may
    reach into history but never beyond encode_end. Returns (best_len,
    best_dist) int32 over the whole lane, 0/0 where no usable match."""
    N = data.shape[0]
    if N < 4:
        z = np.zeros(N, np.int32)
        return z, z
    pad = np.concatenate([data, np.zeros(cfg.max_len + 16, np.uint8)])
    h = hash4(data)
    cands = candidates_by_sort(h, cfg.chain, window)       # (N, K)
    pos = np.arange(N, dtype=np.int64)
    cap = np.minimum(cfg.max_len, encode_end - pos)        # (N,)
    valid = cands >= 0
    w8 = _build_w8(pad)

    # 16-byte prefix of every candidate (two u64 xors)
    ci = np.where(valid, cands, 0).astype(np.int64)
    x1 = w8[pos][:, None] ^ w8[ci]
    x2 = w8[pos + 8][:, None] ^ w8[ci + 8]
    len16 = _ctz_bytes(x1)
    len16 = np.where(x1 == 0, 8 + _ctz_bytes(x2), len16)   # (N, K)
    len16 = np.where(valid, len16, 0)

    # winner per position: longest prefix, then smallest distance
    dist_all = (pos[:, None] - cands).astype(np.int64)
    score = (len16 << 20) - np.where(valid, dist_all, 1 << 19)
    kbest = np.argmax(score, axis=-1)
    best_cand = cands[pos, kbest].astype(np.int64)
    best_len = len16[pos, kbest]
    best_dist = np.where(best_cand >= 0, pos - best_cand, 0)

    # 8-byte extension of winners that filled the probe (to max_len: nice
    # bounds the search, not the chosen match)
    best_len = np.minimum(best_len, cap)
    active = (best_len == 16) & (best_len < cap) & (best_cand >= 0)
    for _ in range((cfg.max_len - 8 + 7) // 8):
        if not active.any():
            break
        idx = np.nonzero(active)[0]
        x = w8[idx + best_len[idx]] ^ w8[best_cand[idx] + best_len[idx]]
        e = _ctz_bytes(x)
        newlen = np.minimum(best_len[idx] + e, cap[idx])
        still = (e == 8) & (newlen < cap[idx])
        best_len[idx] = newlen
        active[idx] = still
    best_len = np.minimum(best_len, cap)

    # dist-1 run prepass: distance to the next inequality
    eq = data[1:] == data[:-1]
    falses = np.where(~eq, np.arange(eq.size), eq.size)
    next_false = np.minimum.accumulate(falses[::-1])[::-1]
    run_pairs = np.zeros(N, dtype=np.int64)
    run_pairs[:eq.size] = next_false - np.arange(eq.size)
    prev_eq = np.concatenate([[False], eq])
    run_len = np.where(prev_eq & (pos - 1 >= 0), 1 + run_pairs, 0)
    run_len = np.minimum(np.minimum(run_len, cfg.max_len), cap)
    use_run = run_len > best_len
    best_len = np.where(use_run, run_len, best_len)
    best_dist = np.where(use_run, 1, best_dist)

    # drop sub-minimum and too-far-3 matches
    ok = (best_len >= MIN_MATCH) & ~((best_len == MIN_MATCH)
                                     & (best_dist > TOO_FAR))
    best_len = np.where(ok, best_len, 0)
    best_dist = np.where(ok, best_dist, 0)
    return best_len.astype(np.int32), best_dist.astype(np.int32)


def lazy_parse(best_len: np.ndarray, best_dist: np.ndarray,
               encode_start: int, encode_end: int, cfg: MatchConfig):
    """Greedy/lazy token selection by pointer doubling. Returns (sel_pos,
    sel_len, sel_dist) token arrays covering [encode_start, encode_end):
    sel_len == 0 is a literal at sel_pos."""
    N = best_len.shape[0]
    length = best_len.astype(np.int64)
    if cfg.lazy:
        nxt_len = np.concatenate([length[1:], [0]])
        defer = (nxt_len > length) & (length < cfg.max_lazy)
    else:
        defer = np.zeros(N, dtype=bool)
    take = (length >= MIN_MATCH) & ~defer
    step = np.where(take, length, 1)

    nxt = np.minimum(np.arange(N, dtype=np.int64) + step, encode_end)
    sel = _reachable_from(nxt, encode_start, encode_end)

    sel_idx = np.nonzero(sel)[0]
    sel_len = np.where(take[sel_idx], length[sel_idx], 0).astype(np.int32)
    sel_dist = np.where(take[sel_idx], best_dist[sel_idx], 0).astype(np.int32)
    return sel_idx.astype(np.int32), sel_len, sel_dist


def _reachable_from(nxt: np.ndarray, start: int, end: int) -> np.ndarray:
    """Mask (N,) of the positions on the chain start -> nxt[start] -> ...
    -> end, by binary lifting over [0, N] with `end` as the absorbing
    sentinel: hops to the end per node, then a landing check per node."""
    N = nxt.shape[0]
    idx = np.arange(N + 1, dtype=np.int64)
    J = np.where(idx < end, np.minimum(np.concatenate([nxt, [end]]), end),
                 end)
    hops = (idx < end).astype(np.int64)
    nlev = max(1, int(np.ceil(np.log2(max(N, 2)))) + 1)
    levels = [J]
    hop_tab = [hops]
    for _ in range(nlev - 1):
        Jk, Hk = levels[-1], hop_tab[-1]
        hop_tab.append(Hk + Hk[Jk])
        levels.append(Jk[Jk])
    total = hop_tab[-1]                    # steps from node to `end`
    steps = total[start] - total           # steps from start to node
    cur = np.full(N + 1, start, dtype=np.int64)
    s = np.maximum(steps, 0)
    for k in range(nlev - 1, -1, -1):
        bit = 1 << k
        use = (s & bit) > 0
        cur = np.where(use, levels[k][cur], cur)
        s = np.where(use, s - bit, s)
    on_chain = (cur == idx) & (steps >= 0) & (idx >= start) & (idx < end)
    return on_chain[:N]
