"""Huffman table construction and dynamic-header build, batched.

Counterpart of `zlibng_tpu/ops/huffman_jax.py`: every function takes a
batch of G frequency/length rows (lanes x units) and loops over the serial
steps of the exact host construction (huffman/encode.py), vectorized over
the batch:

  huff_lengths    : Moffat-Katajainen in-place merge (phase 1: n - 1 steps),
                    depths by pointer doubling (phase 2), leaves per depth,
                    Kraft-equality restore and stable reassignment
  canonical_rev_codes : canonical codes, bit-reversed per length
  dyn_header      : scan_tree RLE (trees.c:411-453, a 316-step loop) +
                    code-length tree + fixed-slot header tokens

`huff_build` is stage 2 auto's whole build of a lane group's rows (both
tables and the header): on CUDA tensors one launch of the hand-written
kernel `csrc/huffman.cu`, one block per row; on CPU tensors these plain
loops, which stay its readable twin.

A write that the reference drops (`.at[n].set(..., mode="drop")`) goes to a
spare column n here, sliced off afterwards.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from ..format.constants import (
    MAX_BITS, MAX_BL_BITS, REP_3_6, REPZ_3_10, REPZ_11_138,
)
from ..trace import item, upload
from .bitpack import code_tables

I32 = torch.int32

_DMAX = 64          # depth histogram size (tree depth < 64 for any n <= 320)
_FBIG = 1 << 22     # > any frequency this codec feeds (unit sums <= 2^17)


# `launches`: huff_build kernel launches so far (`_build.launches`)
__getattr__ = _build.launch_count("huffman")


def _phase1_scan(a: torch.Tensor, m: torch.Tensor, n: int) -> torch.Tensor:
    """Moffat-Katajainen phase 1 on (G, n) ascending weights a[:, :m] ->
    parent pointers / internal weights (two-pointer pairing loop)."""
    G = a.shape[0]
    dev = a.device
    a = torch.cat([a, torch.zeros((G, 1), dtype=I32, device=dev)], 1)
    rows = torch.arange(G, device=dev)
    s = torch.zeros(G, dtype=torch.int64, device=dev)
    r = torch.zeros_like(s)
    m = m.long()
    spare = torch.full_like(s, n)

    def pick(s, r, t, live):
        av_s = a[rows, s.clamp(max=n - 1)]
        av_r = a[rows, r.clamp(max=n - 1)]
        use_r = (s >= m) | ((r < t) & (av_r < av_s))
        child = torch.where(use_r, av_r, av_s)
        # a Python scalar assigned through tensor indices is copied to
        # the device from pageable memory first: a wait, made here
        a[rows, torch.where(use_r & live, r, spare)] = upload(
            torch.tensor(t, dtype=a.dtype), dev)
        return child, s + (~use_r).long(), r + use_r.long()

    for t in range(n - 1):
        live = t < m - 1
        at_t = torch.where(live, t, spare)
        c1, s1, r1 = pick(s, r, t, live)
        a[rows, at_t] = c1
        c2, s2, r2 = pick(s1, r1, t, live)
        a[rows, at_t] += c2
        s = torch.where(live, s2, s)
        r = torch.where(live, r2, r)
    return a[:, :n]


def _phase2_scan(a: torch.Tensor, m: torch.Tensor, n: int) -> torch.Tensor:
    """Phase 2: parent pointers -> internal node depths, as hops to the
    root by pointer doubling."""
    root = torch.clamp(m.long() - 2, min=0)[:, None]
    idx = torch.arange(n, device=a.device)
    internal = idx < root
    J = torch.where(internal, a.long().clamp(0, n - 1), root)
    H = internal.to(I32)
    for _ in range(max(1, int(math.ceil(math.log2(max(n, 2)))))):
        H = H + torch.where(J != root, H.gather(1, J), 0)
        J = J.gather(1, J)
    return torch.where(internal, H, torch.where(idx == root, 0, a)).to(I32)


def huff_lengths(freqs: torch.Tensor, max_bits: int) -> torch.Tensor:
    """(G, n) int32 freqs -> (G, n) int32 code lengths limited to max_bits,
    bit-identical to huffman/encode.py huffman_code_lengths."""
    G, n = freqs.shape
    dev = freqs.device
    freqs = freqs.to(I32)
    sym = torch.arange(n, dtype=I32, device=dev)
    nz = freqs > 0
    m = nz.sum(1)

    # ascending (freq, sym) among nonzero symbols; zeros pushed to the end
    key = torch.where(nz, freqs * n + sym, 0x7FFFFFF0)
    _, order = torch.sort(key, dim=1, stable=True)
    a0 = freqs.gather(1, order)

    a = _phase2_scan(_phase1_scan(a0, m, n), m, n)

    # leaves per depth from the internal-node depth histogram
    idx = torch.arange(n, device=dev)
    internal_mask = idx <= (m[:, None] - 2)
    d = torch.where(internal_mask, a.long(), _DMAX - 1)
    ih = torch.zeros((G, _DMAX), dtype=I32, device=dev).scatter_add_(
        1, d, internal_mask.to(I32))
    avail = torch.cat([torch.ones((G, 1), dtype=I32, device=dev),
                       2 * ih[:, :-1]], 1)
    cum = torch.cumsum(avail - ih, 1).to(I32)
    # leaf j (decreasing frequency) gets depth = first d with cum[d] > j
    j = torch.arange(n, dtype=I32, device=dev).expand(G, n).contiguous()
    depth_j = torch.searchsorted(cum, j, right=True).to(I32)
    tgt = order.gather(1, (m[:, None] - 1 - j).clamp(0, n - 1).long())
    live_j = j < m[:, None]
    lengths = torch.zeros((G, n + 1), dtype=I32, device=dev).scatter_(
        1, torch.where(live_j, tgt, n), depth_j)[:, :n]

    # single-symbol block: DEFLATE needs a >= 1-bit code
    lengths = torch.where((m == 1)[:, None], nz.to(I32), lengths)

    # ---- Kraft restore (length limit), a no-op when already legal ----
    lengths = torch.where(nz, torch.clamp(lengths, max=max_bits), 0)
    bl = torch.zeros((G, max_bits + 1), dtype=I32, device=dev).scatter_add_(
        1, lengths.long(), nz.to(I32))
    bl[:, 0] = 0
    shifts = max_bits - torch.arange(max_bits + 1, dtype=I32, device=dev)
    kraft = (bl << shifts).sum(1).to(I32)
    excess = kraft - (1 << max_bits)
    steps = item(excess.max()) if G else 0
    cand = torch.arange(max_bits + 1, dtype=I32, device=dev)
    for _ in range(steps):
        active = excess > 0
        # deepest bits < max_bits with a leaf to demote
        ok = (bl > 0) & (cand < max_bits) & (cand > 0)
        bits = torch.where(ok, cand, 0).max(1).values.long()[:, None]
        inc = active.to(I32)[:, None]
        bl = bl.scatter_add(1, bits, -inc).scatter_add(1, bits + 1, 2 * inc)
        bl[:, max_bits] -= inc[:, 0]
        excess = excess - active.to(I32)

    # reassign lengths shallow-to-deep over symbols sorted by
    # (old length asc, freq desc, sym asc)
    key2 = torch.where(nz, lengths * _FBIG - freqs, 0x7FFFFFF0)
    order2 = torch.sort(key2, dim=1, stable=True).indices
    cum_bl = torch.cumsum(bl, 1).to(I32)
    new_len_j = torch.searchsorted(cum_bl, j, right=True).to(I32)
    lengths = torch.zeros((G, n + 1), dtype=I32, device=dev).scatter_(
        1, torch.where(live_j, order2, n), new_len_j)[:, :n]
    return torch.where(nz, lengths, 0)


def canonical_rev_codes(lengths: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Canonical codes for (G, n) `lengths`, bit-reversed over each code's
    length (the LSB-first emission form)."""
    G, n = lengths.shape
    dev = lengths.device
    lengths = lengths.to(I32)
    bl = torch.zeros((G, max_bits + 1), dtype=I32, device=dev).scatter_add_(
        1, lengths.long(), (lengths > 0).to(I32))
    bl[:, 0] = 0
    # next_code[b] = sum_{k<b} bl[k] << (b-k)
    b = torch.arange(max_bits + 1, dtype=I32, device=dev)
    sh = b[:, None] - b[None, :]
    contrib = torch.where(sh > 0, bl[:, None, :] << sh.clamp(min=0), 0)
    next_code = contrib.sum(2).to(I32)
    # rank among same-length symbols by symbol order
    onehot = (lengths[:, :, None] == b).to(I32)
    rank = torch.cumsum(onehot, 1).to(I32) - onehot
    my_rank = (rank * onehot).sum(2).to(I32)
    c = next_code.gather(1, lengths.long()) + my_rank
    rev = torch.zeros_like(c)
    for _ in range(max_bits):
        rev = (rev << 1) | (c & 1)
        c = c >> 1
    rev = rev >> (max_bits - lengths)
    return torch.where(lengths > 0, rev, 0).to(I32)


def huff_table(freqs: torch.Tensor, max_bits: int):
    """(lengths, lsb_first_codes) for (G, n) freqs."""
    lengths = huff_lengths(freqs, max_bits)
    return lengths, canonical_rev_codes(lengths, max_bits)


# ---------------------------------------------------------------------------
# Dynamic-block header (scan_tree RLE + bit-length tree + token assembly)
# ---------------------------------------------------------------------------
_L_TOT = 286 + 30       # concatenated lengths array (hlit + hdist <= 316)
_TMAX = 320             # RLE tokens: singles <= L_TOT, reps cover >= 3 each
# slot 0 block header, slot 1 hlit/hdist/hclen, slots 2..20 perm,
# slots 21+2j / 22+2j the j-th RLE token's code + extra
HDR_SLOTS = 21 + 2 * _TMAX


def _rle_scan(v: torch.Tensor, L: torch.Tensor):
    """scan_tree RLE over v[:, :L] for (G, 316) lengths. Returns
    (tok_sym (G, TMAX), tok_extra (G, TMAX), ntok (G,)); tok_extra = -1 for
    plain code-length symbols, else the repeat-count extra value."""
    G, n = v.shape
    dev = v.device
    v = v.to(I32)
    rows = torch.arange(G, device=dev)
    syms = torch.zeros((G, _TMAX + 1), dtype=I32, device=dev)
    extras = torch.full((G, _TMAX + 1), -1, dtype=I32, device=dev)
    cur = torch.zeros(G, dtype=torch.int64, device=dev)
    prevlen = torch.full((G,), -1, dtype=I32, device=dev)
    count = torch.zeros(G, dtype=I32, device=dev)
    # zlib init: prevlen = -1; max/min from the first length
    first_zero = v[:, 0] == 0
    maxc = torch.where(first_zero, 138, 7).to(I32)
    minc = torch.where(first_zero, 3, 4).to(I32)
    spare = torch.full_like(cur, _TMAX)
    L = L.to(I32)
    for i in range(_L_TOT):
        live = i < L
        curlen = v[:, min(i, n - 1)]
        nextlen = torch.where(i + 1 < L, v[:, min(i + 1, n - 1)], -2)
        cnt = count + 1
        flush = ~((cnt < maxc) & (curlen == nextlen))
        do = live & flush

        em_singles = cnt < minc
        em_rep = ~em_singles & (curlen != 0)
        em_z10 = ~em_singles & (curlen == 0) & (cnt <= 10)
        rep_lit = em_rep & (curlen != prevlen)
        c_rep = cnt - rep_lit.to(I32)

        t0_sym = torch.where(
            em_singles | rep_lit, curlen,
            torch.where(em_rep, REP_3_6,
                        torch.where(em_z10, REPZ_3_10, REPZ_11_138)))
        t0_extra = torch.where(
            em_singles | rep_lit, -1,
            torch.where(em_rep, c_rep - 3,
                        torch.where(em_z10, cnt - 3, cnt - 11)))
        n0 = do
        t1_sym = torch.where(rep_lit, REP_3_6, curlen)
        t1_extra = torch.where(rep_lit, c_rep - 3, -1)
        n1 = do & ((em_singles & (cnt >= 2)) | rep_lit)
        n2 = do & em_singles & (cnt >= 3)

        at = torch.where(n0, cur, spare)
        syms[rows, at] = t0_sym.to(I32)
        extras[rows, at] = t0_extra.to(I32)
        o1 = cur + n0.long()
        at = torch.where(n1, o1, spare)
        syms[rows, at] = t1_sym.to(I32)
        extras[rows, at] = t1_extra.to(I32)
        o2 = o1 + n1.long()
        at = torch.where(n2, o2, spare)
        syms[rows, at] = curlen
        extras[rows, at] = upload(torch.tensor(-1, dtype=extras.dtype),
                                  dev)
        cur = torch.where(do, o2 + n2.long(), cur)

        prevlen = torch.where(do, curlen, prevlen)
        count = torch.where(live, torch.where(flush, 0, cnt), count).to(I32)
        same = curlen == nextlen
        maxc = torch.where(do, torch.where(nextlen == 0, 138,
                                           torch.where(same, 6, 7)),
                           maxc).to(I32)
        minc = torch.where(do, torch.where(nextlen == 0, 3,
                                           torch.where(same, 3, 4)),
                           minc).to(I32)
    return syms[:, :_TMAX], extras[:, :_TMAX], cur.to(I32)


def dyn_header(lit_lengths: torch.Tensor, dist_lengths: torch.Tensor,
               btype_bits: int):
    """Dynamic-block headers for (G, >=286) literal and (G, 30) distance
    lengths as fixed-slot (lo int64, nb int32) (G, HDR_SLOTS) token arrays
    plus (G,) total bits; token-stream-identical to huffman/encode.py
    build_dynamic_header with the 3-bit block header in slot 0."""
    G = lit_lengths.shape[0]
    dev = lit_lengths.device
    ll = lit_lengths.to(I32)[:, :286]
    dl = dist_lengths.to(I32)
    i286 = torch.arange(286, dtype=I32, device=dev)
    i30 = torch.arange(30, dtype=I32, device=dev)
    hlit = torch.clamp(torch.where(ll > 0, i286 + 1, 0).max(1).values, min=257)
    hdist = torch.clamp(torch.where(dl > 0, i30 + 1, 0).max(1).values, min=1)

    # concatenated lengths v[i] = ll[i] (i < hlit) else dl[i - hlit]
    i = torch.arange(_L_TOT, dtype=torch.int64, device=dev)
    ll_pad = torch.cat([ll, torch.zeros((G, 30), dtype=I32, device=dev)], 1)
    dl_pad = torch.cat([dl, torch.zeros((G, 286), dtype=I32, device=dev)], 1)
    v = torch.where(i < hlit[:, None], ll_pad,
                    dl_pad.gather(1, (i - hlit[:, None]).clamp(0, 315)))
    L = hlit + hdist

    syms, extras, ntok = _rle_scan(v, L)
    live = torch.arange(_TMAX, device=dev) < ntok[:, None]
    cl_freqs = torch.zeros((G, 20), dtype=I32, device=dev).scatter_add_(
        1, torch.where(live, syms, 19).long(), torch.ones_like(syms))[:, :19]
    cl_len, cl_code = huff_table(cl_freqs, MAX_BL_BITS)

    C = code_tables(dev)
    perm = cl_len[:, C["bl_order"]]
    i19 = torch.arange(19, dtype=I32, device=dev)
    hclen = torch.clamp(torch.where(perm > 0, i19 + 1, 0).max(1).values, min=4)

    lo = torch.zeros((G, HDR_SLOTS), dtype=torch.int64, device=dev)
    nb = torch.zeros((G, HDR_SLOTS), dtype=I32, device=dev)
    lo[:, 0] = btype_bits
    nb[:, 0] = 3
    lo[:, 1] = ((hlit - 257) | ((hdist - 1) << 5) | ((hclen - 4) << 10)).long()
    nb[:, 1] = 14
    lo[:, 2:21] = perm.long()
    nb[:, 2:21] = torch.where(i19 < hclen[:, None], 3, 0).to(I32)
    sl = syms.long()
    cl_lo = torch.where(live, cl_code.gather(1, sl), 0)
    cl_nb = torch.where(live, cl_len.gather(1, sl), 0)
    ex_nb = torch.where(live & (extras >= 0), C["cl_extra"][sl], 0)
    ex_lo = torch.where(ex_nb > 0, extras, 0)
    lo[:, 21::2] = cl_lo.long()
    nb[:, 21::2] = cl_nb.to(I32)
    lo[:, 22::2] = ex_lo.long()
    nb[:, 22::2] = ex_nb.to(I32)
    return lo, nb, nb.sum(1).to(I32)


# ---------------------------------------------------------------------------
# The whole build of a lane group: the kernel on a card, the plain loops here
# ---------------------------------------------------------------------------
def huff_build(lfreq: torch.Tensor, dfreq: torch.Tensor, btype_bits: int):
    """Tables and dynamic headers of G rows: (G, 286) literal/length and
    (G, 30) distance int32 frequencies -> (llen, lcode, dlen, dcode,
    hdr_lo, hdr_nb, hdr_bits), that is huff_table of each at MAX_BITS and
    dyn_header(llen, dlen, btype_bits). The kernel `csrc/huffman.cu` for
    CUDA tensors, the plain version for CPU tensors."""
    if lfreq.is_cuda:
        return _huff_build_cuda(lfreq, dfreq, btype_bits)
    if lfreq.device.type != "cpu":
        raise ValueError(f"huff_build: unsupported device {lfreq.device}")
    return _huff_build_plain(lfreq, dfreq, btype_bits)


def _huff_build_plain(lfreq: torch.Tensor, dfreq: torch.Tensor,
                      btype_bits: int):
    """The plain version, on any device: huff_table x 2 + dyn_header."""
    llen, lcode = huff_table(lfreq, MAX_BITS)
    dlen, dcode = huff_table(dfreq, MAX_BITS)
    return (llen, lcode, dlen, dcode, *dyn_header(llen, dlen, btype_bits))


def _huff_build_cuda(lfreq: torch.Tensor, dfreq: torch.Tensor,
                     btype_bits: int):
    """Runs the kernel on CUDA tensors: one launch on the current stream."""
    dev = _build.check_int32("huffman kernel", lfreq, dfreq)
    G = lfreq.shape[0]
    if lfreq.shape != (G, 286) or dfreq.shape != (G, 30):
        raise ValueError("huffman kernel: frequencies must be (G, 286) and "
                         "(G, 30)")
    out = (torch.empty((G, 286), dtype=I32, device=dev),
           torch.empty((G, 286), dtype=I32, device=dev),
           torch.empty((G, 30), dtype=I32, device=dev),
           torch.empty((G, 30), dtype=I32, device=dev),
           torch.empty((G, HDR_SLOTS), dtype=torch.int64, device=dev),
           torch.empty((G, HDR_SLOTS), dtype=I32, device=dev),
           torch.empty(G, dtype=I32, device=dev))
    if G:
        _build.launch("huffman", dev, lfreq, dfreq, *out, G, btype_bits)
    return out
