"""Huffman encoding on the host: length-limited tree build, canonical
codes, and the dynamic-block header (code-length-tree RLE).

The host encoder's copy of `zlibng_tpu/huffman/encode.py` (zlib-ng
trees.c build_tree/gen_bitlen/gen_codes :185-405, scan_tree/send_tree
:411-521). `huffman_table` and `build_dynamic_header` take the host
runtime's C build of the same construction first (`native/zng_host.c`,
identical tie-breaking), else the numpy route below; the tests hold both
routes to the reference's.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..format.constants import (
    BL_ORDER, MAX_BITS, MAX_BL_BITS, REP_3_6, REPZ_3_10, REPZ_11_138,
    canonical_codes, reverse_bits,
)


def huffman_code_lengths(freqs: np.ndarray,
                         max_bits: int = MAX_BITS) -> np.ndarray:
    """Prefix code lengths for `freqs`, limited to max_bits: the in-place
    sorted-merge (Moffat-Katajainen) construction, then an overflow
    adjustment when a length exceeds max_bits. Zero-frequency symbols get
    0; a single used symbol gets length 1 (trees.c max_code < 2)."""
    freqs = np.asarray(freqs, dtype=np.int64)
    n = len(freqs)
    used = np.nonzero(freqs > 0)[0]
    lengths = np.zeros(n, dtype=np.int32)
    if used.size == 0:
        return lengths
    if used.size == 1:
        lengths[used[0]] = 1
        return lengths

    # phase 1: a[t] becomes internal weights, then parent pointers
    order = used[np.argsort(freqs[used], kind="stable")]
    a = freqs[order].astype(np.int64).copy()
    m = a.size
    s, r = 0, 0
    for t in range(m - 1):
        if s >= m or (r < t and a[r] < a[s]):          # first child
            a[t] = a[r]
            a[r] = t
            r += 1
        else:
            a[t] = a[s]
            s += 1
        if s >= m or (r < t and a[r] < a[s]):          # second child
            a[t] += a[r]
            a[r] = t
            r += 1
        else:
            a[t] += a[s]
            s += 1
    # phase 2: internal node depths from parent pointers (right to left)
    a[m - 2] = 0
    for t in range(m - 3, -1, -1):
        a[t] = a[a[t]] + 1
    # phase 3: leaf depths by counting internal nodes per depth
    avail, depth = 1, 0
    depths = np.zeros(m, dtype=np.int32)
    t = m - 2
    out_i = 0
    while avail > 0:
        usedn = 0
        while t >= 0 and a[t] == depth:
            usedn += 1
            t -= 1
        for _ in range(avail - usedn):
            depths[out_i] = depth
            out_i += 1
        avail = 2 * usedn
        depth += 1
    # depths[] runs from the most frequent symbol; `order` is ascending
    lengths[order[::-1]] = depths

    if lengths.max() > max_bits:
        lengths = _limit_lengths(freqs, lengths, max_bits)
    return lengths


def _limit_lengths(freqs: np.ndarray, lengths: np.ndarray,
                   max_bits: int) -> np.ndarray:
    """Clamp deep codes to max_bits, then move leaves down until the Kraft
    sum is exact again (one unit of 2^-max_bits per move: exact for trees
    of any depth, where trees.c's node count assumes one level past the
    limit)."""
    lengths = lengths.copy()
    lengths[lengths > max_bits] = max_bits
    bl_count = np.bincount(lengths, minlength=max_bits + 1)
    bl_count[0] = 0
    kraft = int((bl_count[1:] << np.arange(max_bits - 1, -1, -1)).sum())
    target = 1 << max_bits
    while kraft > target:
        bits = max_bits - 1
        while bl_count[bits] == 0:
            bits -= 1
        bl_count[bits] -= 1
        bl_count[bits + 1] += 2
        bl_count[max_bits] -= 1
        kraft -= 1
    # symbols by (old length asc, freq desc) take the new lengths in order
    used = np.nonzero(lengths > 0)[0]
    key = lengths[used] * (freqs.max() + 1) - freqs[used]
    order = used[np.argsort(key, kind="stable")]
    new_lengths = np.repeat(
        np.arange(max_bits + 1), bl_count[: max_bits + 1]).astype(np.int32)
    lengths[order] = new_lengths
    return lengths


def huffman_table(freqs: np.ndarray, max_bits: int = MAX_BITS):
    """(lengths, lsb_first_codes) ready for bitstream emission."""
    freqs = np.asarray(freqs)
    if freqs.size <= 320 and native.available():
        return native.huff_table(freqs, max_bits)
    lengths = huffman_code_lengths(freqs, max_bits)
    codes = canonical_codes(lengths, max_bits)
    return lengths, reverse_bits(codes, lengths, max_bits)


def rle_code_lengths(lengths: np.ndarray) -> list[tuple[int, int]]:
    """RLE a lengths array into (cl_symbol, extra_value) pairs with codes
    16/17/18, as scan_tree does (trees.c:411-453)."""
    out = []
    n = len(lengths)
    prev = -1
    i = 0
    while i < n:
        cur = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == cur:
            run += 1
        if cur == 0:
            r = run
            while r >= 11:
                take = min(r, 138)
                out.append((REPZ_11_138, take - 11))
                r -= take
            if r >= 3:
                out.append((REPZ_3_10, r - 3))
                r = 0
            for _ in range(r):
                out.append((0, -1))
        else:
            r = run
            if cur != prev:
                out.append((cur, -1))
                r -= 1
            while r >= 3:
                take = min(r, 6)
                out.append((REP_3_6, take - 3))
                r -= take
            for _ in range(r):
                out.append((cur, -1))
        prev = cur
        i += run
    return out


# extra bit counts for cl codes 16/17/18
_CL_EXTRA = {REP_3_6: 2, REPZ_3_10: 3, REPZ_11_138: 7}


def build_dynamic_header(lit_lengths: np.ndarray, dist_lengths: np.ndarray):
    """The dynamic-block header as a (value, nbits) token list and its
    total bits (trees.c send_all_trees)."""
    if native.available():
        tv, tb, total = native.dyn_header(lit_lengths, dist_lengths)
        return list(zip(tv.tolist(), tb.tolist())), total
    # trailing-zero trimming with the minimums hlit >= 257, hdist >= 1
    hlit = max(257, int(np.max(np.nonzero(lit_lengths)[0])) + 1) \
        if np.any(lit_lengths) else 257
    nz_d = np.nonzero(dist_lengths)[0]
    hdist = max(1, int(nz_d.max()) + 1) if nz_d.size else 1

    rle = rle_code_lengths(np.concatenate([lit_lengths[:hlit],
                                           dist_lengths[:hdist]]))
    cl_freqs = np.zeros(19, dtype=np.int64)
    for sym, _ in rle:
        cl_freqs[sym] += 1
    cl_lengths, cl_codes = huffman_table(cl_freqs, MAX_BL_BITS)

    # hclen: trim trailing zeros in BL_ORDER permutation (min 4)
    perm = cl_lengths[BL_ORDER]
    nz = np.nonzero(perm)[0]
    hclen = max(4, int(nz.max()) + 1) if nz.size else 4

    tokens = [(hlit - 257, 5), (hdist - 1, 5), (hclen - 4, 4)]
    for i in range(hclen):
        tokens.append((int(perm[i]), 3))
    for sym, extra in rle:
        tokens.append((int(cl_codes[sym]), int(cl_lengths[sym])))
        if sym >= 16:
            tokens.append((extra, _CL_EXTRA[sym]))
    total_bits = sum(nb for _, nb in tokens)
    return tokens, total_bits
