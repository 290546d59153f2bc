"""Block-parallel DEFLATE encoder on the card: the port's main path.

Counterpart of `zlibng_tpu/ops/deflate_tpu.py`:

  host:   slice the input into payload lanes (64-256 KiB), each with the
          previous 32 KiB as read-only history; group up to 2 MiB of lanes
  device: stage 1 — hash/sort/probe (K1, then the deep probes for tuned
          chains beyond 64)/extend/lazy rule per lane [ops/lz77.py], the
          parse walk (K2) [ops/parse.py], per-unit symbol histograms
  device: stage 2, auto — block partition (entropy-estimate DP), exact
          Huffman tables + dynamic headers [ops/huffman.py], block-type
          choice from exact bits, token render + bit pack
          [ops/bitpack_merge.py]; or the fixed-tree quick path (L1 and
          Z_FIXED): each unit's exact static bits from stage 1, static
          codes in closed form, render + pack
  host:   fetch per-unit descriptors and the packed bytes; bit-level
          stitch (stored blocks from the raw input) + zlib/gzip framing

Level 0 and inputs under 1024 bytes run on the host encoder
(stream/deflate.py), as in the reference.

The lane geometry (LANE_BLOCKS, UNIT, the lane-size rule, OUT_BUCKETS)
decides the bytes and equals the reference's, so the output is
byte-identical to `compress_tpu`.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import trace as _trace_mod
from ..checksum.adler32 import adler32
from ..checksum.crc32 import crc32
from ..errors import StreamError
from ..format import headers as H
from ..format.constants import (
    DIST_EXTRA, FIXED_DIST_CODES_REV, FIXED_DIST_LENGTHS, FIXED_LIT_CODES_REV,
    FIXED_LIT_LENGTHS, LENGTH_EXTRA, MAX_BITS, WINDOW_SIZE, effective_window,
)
from ..huffman.bitpack import pack_bits
from ..stream.deflate import (
    LEVELS, Z_DEFAULT_STRATEGY, Z_FIXED, level_config_from,
)
from ..stream.deflate import compress as compress_host
from ..trace import span, trace
from .bitpack import _or_field
from .bitpack_merge import hierarchical_pack
from .huffman import dyn_header, huff_table
from .lz77 import (
    dist_code_arith, dist_extra_arith, finalize_tokens,
    length_code_arith, length_extra_arith, lz77_lane, unit_freqs,
)
from .parse import parse_select_encode

I32 = torch.int32

# bit-accounting audit counters (trees.c:693 compressed_len == bits_sent
# analog; populated only while tracing is enabled)
audit = {"groups_checked": 0, "bit_overruns": 0}
# seconds per stage of the last compress call: device time between CUDA
# events around each stage's work on a card, host wall time on the CPU
stage_seconds = {"stage1": 0.0, "stage2": 0.0, "stitch": 0.0}

LANE_HIST = WINDOW_SIZE          # 32768
# payload-size buckets for one lane (the 32K history prefix is hashed and
# probed but never emits, so bigger lanes amortize it)
LANE_BLOCKS = (1 << 16, 1 << 17, 1 << 18)
UNIT = 1 << 14                   # 16384: stored/tree choice granule
# per-unit packed body buckets (bytes); the host picks the smallest that
# fits its estimate and redoes a group whose exact bits overflow it
OUT_BUCKETS = (4096, 8192, 12288, 16384, UNIT * 15 // 8 + 8)
# upload-size buckets (lanes of real payload per group upload); lanes
# beyond the upload read clamped tail bytes and are masked by enc_end
_UP_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
# payload bytes per lane group (8 lanes at 256 KiB)
GROUP_BYTES = 1 << 21
# lane groups in flight between stage 1 and the stitch
DEPTH = 2
HDR_OUT = 512            # header pack bucket (worst dynamic header < 440 B)
_INF = 1 << 29


def _device(device) -> torch.device:
    """The device a compress call runs on; a CUDA request without a card
    raises (the path never carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("compress_cuda: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"compress_cuda: unsupported device {dev}")
    return dev


class _StageClock:
    """Per-stage seconds of one compress call: on a card, device time
    between CUDA events recorded around each device stage's work (read
    once, after the run); on the CPU, and for the host stitch, the host's
    clock."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.events: list[tuple[str, object, object]] = []
        self.seconds = dict.fromkeys(stage_seconds, 0.0)

    @contextlib.contextmanager
    def stage(self, name: str, on_device: bool = True):
        if self.cuda and on_device:
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            self.events.append((name, a, b))
        else:
            t0 = time.perf_counter()
            yield
            self.seconds[name] += time.perf_counter() - t0

    def publish(self) -> None:
        if self.events:
            torch.cuda.synchronize()
            for name, a, b in self.events:
                self.seconds[name] += a.elapsed_time(b) / 1e3
        stage_seconds.update(self.seconds)


# ---------------------------------------------------------------------------
# device stages
# ---------------------------------------------------------------------------
def _lane_slices(flat: torch.Tensor, first: int, stride: int, length: int,
                 count: int) -> torch.Tensor:
    """(count, length) windows of `flat` at first + i * stride, each start
    clamped so the window fits (the reference's dynamic_slice rule)."""
    top = flat.shape[0] - length
    return torch.stack([flat[min(first + i * stride, top):][:length]
                        for i in range(count)])


def _stage1(flat, enc_ends, hist_valids, lane_block, chain, lazy, max_lazy,
            nice=258, strategy=0, good=12, max_dist=WINDOW_SIZE,
            quick=False):
    """flat: (LANE_HIST + Bup*lane_block,) uint8, the group's payload with
    its 32K history prefix; enc_ends, hist_valids: (B,) int32 on the same
    device. Returns (tokens dict (B, N), lfreqs (B, qpl, 286),
    dfreqs (B, qpl, 30)); with `quick`, (tokens, fb (B, qpl) int32, None):
    each unit's exact static-tree body bits, all the fixed-tree stage 2
    needs from the host."""
    lane = LANE_HIST + lane_block
    B = enc_ends.shape[0]
    lanes = _lane_slices(flat, 0, lane_block, lane, B)
    core = lz77_lane(lanes, LANE_HIST, enc_ends, hist_valids, chain, lazy,
                     max_lazy, nice, unit=UNIT, strategy=strategy, good=good,
                     max_dist=max_dist)
    qpl = lane_block // UNIT
    bounds = torch.stack([torch.full_like(enc_ends, LANE_HIST), enc_ends],
                         1).to(I32).contiguous()
    sel = parse_select_encode(core["step"], bounds)
    outs = finalize_tokens(lanes, core, sel)
    lfreqs, dfreqs = unit_freqs(outs["lsym"], outs["dsym"], outs["sel"],
                                outs["tok_len"] > 0, LANE_HIST, UNIT, qpl)
    toks = dict(sel=outs["sel"], tok_len=outs["tok_len"],
                tok_dist=outs["tok_dist"])
    if quick:
        # product of the counts and the static code + extra lengths as an
        # elementwise product and an int32 sum (no int32 matmul on CUDA;
        # exact, counts <= UNIT)
        C = _consts(flat.device)
        fb = ((lfreqs * (C["fll"] + C["lext"])).sum(-1, dtype=I32)
              + (dfreqs * (C["fdl"] + C["dext"])).sum(-1, dtype=I32))
        return toks, fb, None
    return toks, lfreqs, dfreqs


def _render_pack_unit(qbytes, tl, td, se, lt, lc, dt, dc, out_bytes):
    """Demotion + render + pack of (U, UNIT) units against per-unit
    (lt, lc, dt, dc) code tables ((U, 288) and (U, 30))."""
    tl = tl.to(I32)
    td = td.to(I32)
    U, N = tl.shape
    pos = torch.arange(N, dtype=I32, device=tl.device)

    # cost-model demotion: under the unit's real tables, a selected match
    # whose bits exceed its span's literal bits becomes literals
    is_match = (tl > 0) & se
    lsm = torch.where(is_match, length_code_arith(tl.clamp(min=3)), 257)
    dsm = torch.where(is_match, dist_code_arith(td.clamp(min=1)), 0)
    le_, lv_ = length_extra_arith(tl.clamp(min=3))
    de_, dv_ = dist_extra_arith(td.clamp(min=1))
    qb = qbytes.long()
    lit_code, lit_len = lc.gather(1, qb), lt.gather(1, qb)
    m_code, m_len = lc.gather(1, lsm.long()), lt.gather(1, lsm.long())
    d_code, d_len = dc.gather(1, dsm.long()), dt.gather(1, dsm.long())
    match_bits = m_len + le_ + d_len + de_
    csum = torch.cumsum(torch.stack([lit_len, (lit_len == 0).to(I32)], -1),
                        1).to(I32)
    csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], 1)
    endq = (pos + tl).clamp(0, N).long()
    at_end = csum.gather(1, endq[..., None].expand(U, N, 2))
    span_bits = at_end[..., 0] - csum[:, :-1, 0]
    span_zero = (at_end[..., 1] - csum[:, :-1, 1]) > 0
    demote = is_match & ~span_zero & (match_bits > span_bits)
    end_max = torch.where(demote, pos + tl, 0).cummax(1).values
    covered = pos < end_max
    se = se | covered

    fm = is_match & ~covered
    code0 = torch.where(fm, m_code, lit_code).to(torch.int64)
    n0 = torch.where(fm, m_len, lit_len)
    le = torch.where(fm, le_, 0)
    lv = torch.where(fm, lv_, 0)
    dcode = torch.where(fm, d_code, 0)
    dn = torch.where(fm, d_len, 0)
    de = torch.where(fm, de_, 0)
    dv = torch.where(fm, dv_, 0)
    lo, hi = code0, torch.zeros_like(code0)
    sh = n0
    lo, hi = _or_field(lo, hi, lv, sh)
    sh = sh + le
    lo, hi = _or_field(lo, hi, dcode, sh)
    sh = sh + dn
    lo, hi = _or_field(lo, hi, dv, sh)
    nb = torch.where(se, n0 + le + dn + de, 0).to(I32)
    lo = torch.where(se, lo, 0)
    hi = torch.where(se, hi, 0)
    return hierarchical_pack(lo, hi, nb, out_bytes)


def _consts(dev):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    lext = np.zeros(286, np.int32)
    lext[257:286] = LENGTH_EXTRA[:29]
    return dict(lext=t(lext), dext=t(DIST_EXTRA[:30]),
                fll=t(FIXED_LIT_LENGTHS[:286]), fl288=t(FIXED_LIT_LENGTHS),
                flc=t(FIXED_LIT_CODES_REV), fdl=t(FIXED_DIST_LENGTHS),
                fdc=t(FIXED_DIST_CODES_REV))


def _ent(f: torch.Tensor, tot: torch.Tensor) -> torch.Tensor:
    """Float32 entropy bits of each row of counts f with totals tot."""
    fv = f.to(torch.float32)
    safe = torch.clamp(fv, min=1.0)
    return torch.where(f > 0, fv * (torch.log2(torch.clamp(tot, min=1.0))
                                    - torch.log2(safe)), 0.0).sum(-1)


def _est_dyn(freqs: torch.Tensor, lext: torch.Tensor,
             dext: torch.Tensor) -> torch.Tensor:
    """Estimated dynamic-block bits (int32) of each node from its (...,
    286 + 30) literal/length and distance counts: entropy + extra bits +
    a header model, in float32 in the reference's order of operations.

    It runs on the host CPU whatever the stage's device: a card's log2
    and summation order differ from the CPU's in the last ulp (chip_smoke.py
    counts the differing values), and after the int32 truncation that
    could flip a near-tie partition; on the host, the card's path computes
    the CPU path's bytes."""
    lf, df = freqs[..., :286], freqs[..., 286:]
    extra = (lf * lext).sum(-1) + (df * dext).sum(-1)
    used = (lf > 0).sum(-1) + (df > 0).sum(-1)
    est = _ent(lf, lf.sum(-1, keepdim=True).to(torch.float32)) \
        + _ent(df, df.sum(-1, keepdim=True).to(torch.float32))
    est = est + extra.to(torch.float32)
    est = est + 3
    est = est + 14
    est = est + 57
    est = est + 5 * used.to(torch.float32)
    return est.to(I32)


def _lane_stage2_auto(pay, tlq, tdq, seq, lfreq_u, dfreq_u, unit_lens,
                      out_bytes: int, qpl: int):
    """B lanes: node pyramid over each lane's qpl units, exact three-way
    stored/static/dynamic costs with in-graph Huffman tables and dynamic
    headers, the optimal contiguous power-of-2 partition by DP, then the
    per-unit render + pack (zlib-ng trees.c:322-405 tree build, :411-521
    header, :657-692 block-type choice). pay/tlq/tdq/seq: (B, qpl, UNIT);
    lfreq_u (B, qpl, 286); dfreq_u (B, qpl, 30); unit_lens (B, qpl)."""
    B = pay.shape[0]
    dev = pay.device
    C = _consts(dev)
    nlev = qpl.bit_length()                    # qpl = 2^(nlev-1)

    # ---- node pyramid: freqs / stored cost / empty-unit poisoning -------
    lf_lv = [lfreq_u.to(I32)]
    df_lv = [dfreq_u.to(I32)]
    sto_lv = [torch.where(unit_lens > 0, 42 + 8 * unit_lens, 0).to(I32)]
    emp_lv = [unit_lens == 0]
    for _ in range(nlev - 1):
        for lv in (lf_lv, df_lv, sto_lv):
            lv.append(lv[-1][:, 0::2] + lv[-1][:, 1::2])
        emp_lv.append(emp_lv[-1][:, 0::2] | emp_lv[-1][:, 1::2])
    nlf = torch.cat(lf_lv, 1)                  # (B, nodes, 286)
    ndf = torch.cat(df_lv, 1)                  # (B, nodes, 30)
    nsto = torch.cat(sto_lv, 1)
    nemp = torch.cat(emp_lv, 1)
    nodes = nlf.shape[1]                       # 2*qpl - 1
    is_leaf = torch.arange(nodes, device=dev) < qpl

    # ---- per-node estimated costs for the partition ---------------------
    lfreq_n = nlf.clone()
    lfreq_n[..., 256] += 1                     # one EOB per block
    extra_n = ((lfreq_n * C["lext"]).sum(-1)
               + (ndf * C["dext"]).sum(-1)).to(I32)
    est_dyn_n = _est_dyn(torch.cat([lfreq_n, ndf], -1).cpu(),
                         C["lext"].cpu(), C["dext"].cpu()).to(dev)
    sta_n = ((lfreq_n * C["fll"]).sum(-1) + (ndf * C["fdl"]).sum(-1)
             + extra_n + 3).to(I32)
    cost_n = torch.minimum(torch.minimum(est_dyn_n, sta_n), nsto)
    # internal nodes containing an empty (tail) unit never form a block
    cost_dp = torch.where(~is_leaf & nemp, _INF, cost_n)

    # ---- DP: optimal contiguous power-of-2 partition --------------------
    offs = [sum(qpl >> k for k in range(lv)) for lv in range(nlev)]
    best = cost_dp[:, :qpl]
    split_lv = [None]
    for lv in range(1, nlev):
        own = cost_dp[:, offs[lv]: offs[lv] + (qpl >> lv)]
        kids = best[:, 0::2] + best[:, 1::2]
        split = kids < own                     # merge on ties
        split_lv.append(split)
        best = torch.where(split, kids, own)

    # ---- walk down: per-unit assigned node ------------------------------
    q = torch.arange(qpl, device=dev)
    assign = torch.zeros((B, qpl), dtype=torch.int64, device=dev)
    taken = torch.zeros((B, qpl), dtype=torch.bool, device=dev)
    lv_of = torch.zeros((B, qpl), dtype=I32, device=dev)
    for lv in range(nlev - 1, -1, -1):
        j = q >> lv
        take = ~taken
        if lv > 0:
            take = take & ~split_lv[lv][:, j]
        assign = torch.where(take, offs[lv] + j, assign)
        lv_of = torch.where(take, lv, lv_of)
        taken = taken | take
    span = 1 << lv_of                          # units in my block
    first_q = (q & (span - 1)) == 0
    last_q = (q & (span - 1)) == span - 1

    # ---- exact build for the qpl assigned blocks ------------------------
    G = B * qpl
    lfreq_b = lfreq_n.gather(1, assign[..., None].expand(B, qpl, 286))
    dfreq_b = ndf.gather(1, assign[..., None].expand(B, qpl, 30))
    llen_b, lcode_b = huff_table(lfreq_b.reshape(G, 286), MAX_BITS)
    dlen_b, dcode_b = huff_table(dfreq_b.reshape(G, 30), MAX_BITS)
    hdr_lo_b, hdr_nb_b, hdr_bits_b = dyn_header(llen_b, dlen_b, 4)
    # exact block-type choice (trees.c:657-692): dyn vs static vs stored
    extra_b = extra_n.gather(1, assign)
    dyn_b = ((lfreq_b * llen_b.reshape(B, qpl, 286)).sum(-1)
             + (dfreq_b * dlen_b.reshape(B, qpl, 30)).sum(-1)
             + extra_b + hdr_bits_b.reshape(B, qpl))
    sta_b = sta_n.gather(1, assign)
    sto_b = nsto.gather(1, assign)
    best_code = torch.minimum(dyn_b, sta_b)    # static wins ties
    use_dyn = dyn_b < sta_b
    use_sto = sto_b < best_code + 3
    btype_u = torch.where(use_sto, 0, torch.where(use_dyn, 2, 1))
    btype_u = torch.where(unit_lens > 0, btype_u, 0).reshape(G)

    # ---- per-unit tables + body render/pack -----------------------------
    dynsel = (btype_u == 2)[:, None]
    z2 = torch.zeros((G, 2), dtype=I32, device=dev)
    lt_u = torch.where(dynsel, torch.cat([llen_b, z2], 1), C["fl288"])
    lc_u = torch.where(dynsel, torch.cat([lcode_b, z2], 1), C["flc"])
    dt_u = torch.where(dynsel, dlen_b, C["fdl"])
    dc_u = torch.where(dynsel, dcode_b, C["fdc"])
    body_packed, body_bits = _render_pack_unit(
        pay.reshape(G, UNIT), tlq.reshape(G, UNIT), tdq.reshape(G, UNIT),
        seq.reshape(G, UNIT), lt_u, lc_u, dt_u, dc_u, out_bytes)

    # ---- per-unit header pack (first-of-block only) ---------------------
    first_q = first_q.reshape(G)
    last_q = last_q.reshape(G)
    is_dyn_hdr = (first_q & (btype_u == 2))[:, None]
    is_sta_hdr = first_q & (btype_u == 1)
    hlo_u = torch.where(is_dyn_hdr, hdr_lo_b, 0)
    hnb_u = torch.where(is_dyn_hdr, hdr_nb_b, 0)
    # static header: a single 3-bit token in slot 0 (BFINAL patched on host)
    hlo_u[:, 0] = torch.where(is_sta_hdr, 2, hlo_u[:, 0])
    hnb_u[:, 0] = torch.where(is_sta_hdr, 3, hnb_u[:, 0])
    hdr_packed, hdr_bits = hierarchical_pack(hlo_u, torch.zeros_like(hlo_u),
                                             hnb_u, HDR_OUT)

    # ---- per-unit descriptor: btype | first | last | eob ----------------
    eob_code = torch.where(btype_u == 2, lcode_b[:, 256], C["flc"][256])
    eob_nb = torch.where(btype_u == 2, llen_b[:, 256], 7)
    has_eob = last_q & (btype_u != 0)
    desc = (btype_u | (first_q.to(I32) << 2) | (last_q.to(I32) << 3)
            | (torch.where(has_eob, eob_nb, 0) << 4)
            | (torch.where(has_eob, eob_code, 0) << 9))
    meta = torch.stack([body_bits, hdr_bits, desc.to(I32)], -1).to(I32)
    return (body_packed.reshape(B, qpl, out_bytes),
            hdr_packed.reshape(B, qpl, HDR_OUT), meta.reshape(B, qpl, 3))


def _stage2_auto(flat, tok_len, tok_dist, sel, lfreqs, dfreqs, enc_ends,
                 lane_block: int, out_bytes: int):
    """Stage 2 over a lane group: tables, headers, partition and block
    types on the device; returns (body (B, qpl, out_bytes) uint8,
    hdr (B, qpl, HDR_OUT) uint8, meta (B, qpl, 3) int32 =
    [body_bits, hdr_bits, desc])."""
    qpl = lane_block // UNIT
    B = tok_len.shape[0]
    pay = _lane_slices(flat, LANE_HIST, lane_block, lane_block,
                       B).reshape(B, qpl, UNIT)
    tlq = tok_len[:, LANE_HIST:].to(I32).reshape(B, qpl, UNIT)
    tdq = tok_dist[:, LANE_HIST:].to(I32).reshape(B, qpl, UNIT)
    seq = sel[:, LANE_HIST:].reshape(B, qpl, UNIT)
    qoff = torch.arange(qpl, dtype=I32, device=flat.device) * UNIT
    unit_lens = (enc_ends.to(I32)[:, None] - LANE_HIST - qoff).clamp(0, UNIT)
    return _lane_stage2_auto(pay, tlq, tdq, seq, lfreqs, dfreqs, unit_lens,
                             out_bytes, qpl)


def _bitrev16(v: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low 16 bits of v (int32, 0 <= v < 2^16)."""
    v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
    v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
    v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
    return ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)


def _static_lit_code(sym: torch.Tensor):
    """(lsb_first_code, nbits) int32 of the RFC 1951 §3.2.6 static
    literal/length code of sym (0..287), in closed form: 0-143 -> 8 bits
    from 0x30, 144-255 -> 9 from 0x190, 256-279 -> 7 from 0, 280-287 -> 8
    from 0xC0."""
    sym = sym.to(I32)
    nb = torch.where(sym < 144, 8, torch.where(
        sym < 256, 9, torch.where(sym < 280, 7, 8))).to(I32)
    base = torch.where(
        sym < 144, 0x30 + sym,
        torch.where(sym < 256, 0x190 + sym - 144,
                    torch.where(sym < 280, sym - 256, 0xC0 + sym - 280)))
    return _bitrev16(base) >> (16 - nb), nb


def _render_pack_unit_fixed(qbytes, tl, td, se, out_bytes: int,
                            demote: bool):
    """Static-tree render + pack of (U, UNIT) units, every code computed
    arithmetically. `demote` turns on the cost-model match demotion
    (Z_FIXED); the L1 quick path emits matches unconditionally, as
    zlib-ng's deflate_quick does (deflate_quick.c:47-130)."""
    tl = tl.to(I32)
    td = td.to(I32)
    U, N = tl.shape
    pos = torch.arange(N, dtype=I32, device=tl.device)
    is_match = (tl > 0) & se
    lsm = length_code_arith(tl.clamp(min=3))
    dsm = torch.where(is_match, dist_code_arith(td.clamp(min=1)), 0)
    le_, lv_ = length_extra_arith(tl.clamp(min=3))
    de_, dv_ = dist_extra_arith(td.clamp(min=1))
    lit_code, lit_nb = _static_lit_code(qbytes)
    mcode, mnb = _static_lit_code(lsm)
    dcode_all = _bitrev16(dsm) >> 11                          # 5-bit codes

    if demote:
        # a selected match whose static bits exceed its span's literal bits
        # (8 or 9 each: every byte has a code) becomes literals
        match_bits = mnb + le_ + 5 + de_
        csum = torch.cat([torch.zeros_like(lit_nb[:, :1]),
                          torch.cumsum(lit_nb, 1, dtype=I32)], 1)
        endq = (pos + tl).clamp(0, N).long()
        span_bits = csum.gather(1, endq) - csum[:, :-1]
        demote_m = is_match & (match_bits > span_bits)
        end_max = torch.where(demote_m, pos + tl, 0).cummax(1).values
        covered = pos < end_max
        se = se | covered
        is_match = is_match & ~covered

    fm = is_match
    code0 = torch.where(fm, mcode, lit_code).to(torch.int64)
    n0 = torch.where(fm, mnb, lit_nb)
    le = torch.where(fm, le_, 0)
    lv = torch.where(fm, lv_, 0)
    dcode = torch.where(fm, dcode_all, 0)
    dn = torch.where(fm, 5, 0)
    de = torch.where(fm, de_, 0)
    dv = torch.where(fm, dv_, 0)
    lo, hi = code0, torch.zeros_like(code0)
    sh = n0
    lo, hi = _or_field(lo, hi, lv, sh)
    sh = sh + le
    lo, hi = _or_field(lo, hi, dcode, sh)
    sh = sh + dn
    lo, hi = _or_field(lo, hi, dv, sh)
    nb = torch.where(se, n0 + le + dn + de, 0).to(I32)
    lo = torch.where(se, lo, 0)
    hi = torch.where(se, hi, 0)
    return hierarchical_pack(lo, hi, nb, out_bytes)


def _stage2_fixed(flat, tok_len, tok_dist, sel, lane_block: int,
                  out_bytes: int, demote: bool = True):
    """Fixed-tree stage 2 over a lane group (the deflate_quick design
    point): static codes in closed form, so no table, tree build or
    frequency fetch. Returns (packed (B, qpl, out_bytes) uint8,
    totals (B, qpl) int32 body bits)."""
    qpl = lane_block // UNIT
    B = tok_len.shape[0]
    G = B * qpl
    pay = _lane_slices(flat, LANE_HIST, lane_block, lane_block, B)
    packed, totals = _render_pack_unit_fixed(
        pay.reshape(G, UNIT), tok_len[:, LANE_HIST:].reshape(G, UNIT),
        tok_dist[:, LANE_HIST:].reshape(G, UNIT),
        sel[:, LANE_HIST:].reshape(G, UNIT), out_bytes, demote)
    return packed.reshape(B, qpl, out_bytes), totals.reshape(B, qpl)


def _compact_units(cols: list, nbytes: np.ndarray):
    """Concatenate, unit by unit, the first nbytes[u, j] bytes of row u of
    each (U, width) uint8 tensor cols[j] (U = B * qpl; nbytes a (U, len(
    cols)) host array) into one flat buffer: the fetch shrinks from the
    buckets to the compressed size. Returns (sum(nbytes),) uint8 on the
    device."""
    parts = [col[u, :n] for u in range(nbytes.shape[0])
             for col, n in zip(cols, nbytes[u].tolist()) if n]
    if not parts:
        return cols[0].new_zeros(0)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------
class _BitStitcher:
    """Accumulate bit-aligned parts into one LSB-first byte stream."""

    def __init__(self):
        self.buf = bytearray()
        self.bits = 0

    def append(self, part: np.ndarray, part_bits: int) -> None:
        if part_bits == 0:
            return
        nb = (part_bits + 7) >> 3
        part = part[:nb].astype(np.uint16)
        r = self.bits & 7
        if r == 0:
            if self.bits >> 3 < len(self.buf):
                self.buf = self.buf[: self.bits >> 3]
            self.buf += part.astype(np.uint8).tobytes()
        else:
            sh = np.zeros(nb + 1, np.uint16)
            sh[:nb] |= (part << r) & 0xFF
            sh[1:] |= part >> (8 - r)
            self.buf[-1] |= int(sh[0])
            self.buf += sh[1:].astype(np.uint8).tobytes()
        self.bits += part_bits
        # trim to exact byte length
        need = (self.bits + 7) >> 3
        if len(self.buf) > need:
            del self.buf[need:]

    def append_tokens(self, tokens: list[tuple[int, int]]) -> None:
        """(value, nbits) pairs rendered on host (tiny: stored headers)."""
        vals = np.array([v for v, _ in tokens], np.uint64)
        nbs = np.array([n for _, n in tokens], np.int64)
        by, total = pack_bits(vals, nbs)
        self.append(by, total)

    def getvalue(self) -> bytes:
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------
def deflate_payload_cuda(buf: np.ndarray, level: int = 6,
                         strategy: int = Z_DEFAULT_STRATEGY,
                         dictionary: bytes | None = None, tune=None,
                         max_dist: int = WINDOW_SIZE,
                         device="cuda") -> bytes:
    """Raw DEFLATE payload of `buf` (uint8, >= 1 byte) on `device`.
    `tune` (any object with chain/lazy/max_lazy/nice/good) overrides the
    level's match-engine knobs; `max_dist` bounds match distances. Levels
    below 1 and above 9 take L1's and L9's engine."""
    dev = _device(device)
    lc = level_config_from(tune) if tune is not None \
        else LEVELS[max(1, min(9, level))]
    s1_strategy = strategy if strategy in (1, 2, 3) else 0
    # fixed-tree quick path (deflate_quick, L1 in zlib-ng's
    # configuration_table, deflate.c:142-152): Z_FIXED at any level, and
    # L1 with the default strategy
    quick = strategy == Z_FIXED or (level == 1 and strategy == 0)
    n = buf.size
    # lane geometry by input size: minimize processed positions (history
    # prefix + zero tail), ties to bigger lanes
    lane_block = min(LANE_BLOCKS,
                     key=lambda lb: (-(-n // lb) * (lb + LANE_HIST), -lb))
    qpl = lane_block // UNIT
    max_lanes = max(1, GROUP_BYTES // lane_block)
    nblocks = max(1, -(-n // lane_block))

    # virtual buffer with 32K zero/dict prefix so every lane slices uniformly
    d = np.frombuffer(memoryview(bytes(dictionary)),
                      np.uint8)[-min(LANE_HIST, max_dist):] \
        if dictionary else np.zeros(0, np.uint8)
    prefix = np.concatenate([np.zeros(LANE_HIST - d.size, np.uint8), d])
    tail_pad = np.zeros(nblocks * lane_block - n, np.uint8)
    vbuf = np.concatenate([prefix, buf, tail_pad])
    first_hist_valid = LANE_HIST - d.size
    # one upload of the whole buffer (pinned + non-blocking on a card)
    host = torch.from_numpy(vbuf)
    if dev.type == "cuda":
        vbuf_d = host.pin_memory().to(dev, non_blocking=True)
    else:
        vbuf_d = host

    stitch = _BitStitcher()
    clock = _StageClock(dev)

    def _group_flat(g0: int, B: int) -> torch.Tensor:
        # the group's lanes plus history, zero-padded to the upload bucket
        Bup = next(b for b in _UP_BUCKETS if b >= B)
        base = g0 * lane_block
        flat = vbuf_d[base: base + LANE_HIST + B * lane_block]
        if Bup != B:
            flat = torch.cat([flat, flat.new_zeros((Bup - B) * lane_block)])
        return flat

    @clock.stage("stage1")
    def _dispatch_stage1(g0: int) -> dict:
        g1 = min(g0 + max_lanes, nblocks)
        B = g1 - g0
        Bpad = 1 << (B - 1).bit_length()
        flat_d = _group_flat(g0, B)
        enc_ends = np.full(Bpad, LANE_HIST, np.int32)
        hist_valids = np.zeros(Bpad, np.int32)
        for i, bi in enumerate(range(g0, g1)):
            enc_ends[i] = LANE_HIST + min(lane_block, n - bi * lane_block)
            hist_valids[i] = first_hist_valid if bi == 0 else 0
        enc_ends_d = torch.from_numpy(enc_ends).to(dev)
        with span("deflate stage1 dispatch lanes[%d:%d] Bpad=%d", g0, g1,
                  Bpad):
            toks, a_d, b_d = _stage1(
                flat_d, enc_ends_d, torch.from_numpy(hist_valids).to(dev),
                lane_block, lc.chain, lc.lazy, lc.max_lazy, lc.nice,
                s1_strategy, lc.good, max_dist=max_dist, quick=quick)
        # the quick product is each unit's static body bits, not counts
        s1 = dict(fb_d=a_d) if quick else dict(lfreqs_d=a_d, dfreqs_d=b_d)
        return dict(g0=g0, g1=g1, B=B, Bpad=Bpad, flat_d=flat_d, toks=toks,
                    enc_ends=enc_ends, enc_ends_d=enc_ends_d, **s1)

    def _pick_out_bucket(g0: int, g1: int, enc_ends) -> int:
        """Body-pack bucket from per-unit byte entropy on the host, capped
        at the unit's stored bound; a rare underestimate is caught by the
        overflow redispatch."""
        worst_bits = 0
        for i, bi in enumerate(range(g0, g1)):
            blen = int(enc_ends[i]) - LANE_HIST
            base = LANE_HIST + bi * lane_block
            for q0 in range(0, blen, UNIT):
                ul = min(UNIT, blen - q0)
                cnt = np.bincount(vbuf[base + q0: base + q0 + ul],
                                  minlength=256)
                p = cnt[cnt > 0] / ul
                Hb = float(-(p * np.log2(p)).sum())
                est = min(int(ul * Hb * 1.08) + 4096, 8 * ul + 64)
                worst_bits = max(worst_bits, est)
        for ob in OUT_BUCKETS:
            if worst_bits <= (ob - 8) * 8:
                return ob
        return OUT_BUCKETS[-1]

    def _unit_lens(gm: dict) -> np.ndarray:
        """(Bpad, qpl) payload bytes of each unit of the group (0 past a
        lane's end and in the pad lanes, whose enc_end is LANE_HIST)."""
        blen = gm["enc_ends"][:, None].astype(np.int64) - LANE_HIST
        return np.clip(blen - UNIT * np.arange(qpl), 0, UNIT)

    def _dispatch_stage2_quick(gm: dict) -> None:
        """Fixed-tree stage 2: the host reads each unit's exact static
        body bits, chooses stored units and the output bucket; every coded
        unit is its own static block. L1 compacts the packed units at
        host-known offsets (no demotion, so the bits are exact); Z_FIXED
        demotes matches and fetches the buckets with the device's bits."""
        g0, g1, Bpad = gm["g0"], gm["g1"], gm["Bpad"]
        toks, flat_d = gm["toks"], gm["flat_d"]
        fb = gm["fb_d"].cpu().numpy().astype(np.int64)   # (Bpad, qpl)
        unit_lens = _unit_lens(gm)
        # a unit is stored when its raw form beats its static block
        coded = (unit_lens > 0) & ~(42 + 8 * unit_lens < fb + 10)
        gm.update(unit_lens=unit_lens, coded=coded, flat_packed_d=None,
                  packed_d=None)
        if coded.any():
            max_body_bits = int(fb[coded].max())
            out_bytes = next((ob for ob in OUT_BUCKETS
                              if max_body_bits <= (ob - 8) * 8),
                             OUT_BUCKETS[-1])
            args = (flat_d, toks["tok_len"], toks["tok_dist"], toks["sel"],
                    lane_block, out_bytes)
            if strategy == Z_FIXED:
                with span("deflate stage2-fixed dispatch lanes[%d:%d] "
                          "out=%d", g0, g1, out_bytes):
                    gm["packed_d"], gm["totals_d"] = _stage2_fixed(
                        *args, demote=True)
            else:
                nbytes = np.where(coded, (fb + 7) >> 3, 0)
                gm["unit_off"] = (np.cumsum(nbytes) - nbytes.reshape(-1)) \
                    .reshape(Bpad, qpl)
                gm["unit_bits"] = fb
                with span("deflate stage2-quick-compact lanes[%d:%d] "
                          "out=%d bytes=%d", g0, g1, out_bytes,
                          int(nbytes.sum())):
                    packed, _ = _stage2_fixed(*args, demote=False)
                    gm["flat_packed_d"] = _compact_units(
                        [packed.reshape(Bpad * qpl, out_bytes)],
                        nbytes.reshape(-1, 1))
        del gm["toks"], gm["flat_d"], gm["fb_d"]

    def _dispatch_stage2_auto(gm: dict) -> None:
        """Stage 2 on the device; the host fetches the per-unit descriptor
        and (unless the whole group went stored) one compact buffer."""
        g0, g1, Bpad = gm["g0"], gm["g1"], gm["Bpad"]
        enc_ends, toks, flat_d = gm["enc_ends"], gm["toks"], gm["flat_d"]
        out_bytes = _pick_out_bucket(g0, g1, enc_ends)

        def run(ob):
            return _stage2_auto(flat_d, toks["tok_len"], toks["tok_dist"],
                                toks["sel"], gm["lfreqs_d"], gm["dfreqs_d"],
                                gm["enc_ends_d"], lane_block, ob)

        with span("deflate stage2-auto dispatch lanes[%d:%d] out=%d",
                  g0, g1, out_bytes):
            body, hdr, meta = run(out_bytes)
        meta_np = meta.cpu().numpy()                   # (Bpad, qpl, 3)
        btype = meta_np[:, :, 2] & 3
        nonstored = []
        for i, bi in enumerate(range(g0, g1)):
            blen = int(enc_ends[i]) - LANE_HIST
            for q in range(qpl):
                if min(UNIT, max(0, blen - q * UNIT)) > 0 and btype[i, q]:
                    nonstored.append((i, q))
        # overflow safety: if a coded unit's exact body bits exceed the
        # estimated bucket, redo the group at the exact fit
        need_bits = max((int(meta_np[i, q, 0]) for i, q in nonstored),
                        default=0)
        if need_bits > (out_bytes - 8) * 8:
            out_bytes = next((ob for ob in OUT_BUCKETS
                              if need_bits <= (ob - 8) * 8), OUT_BUCKETS[-1])
            trace("stage2-auto bucket overflow: redispatch at %d", out_bytes)
            body, hdr, meta = run(out_bytes)
            meta_np = meta.cpu().numpy()
        gm["flat_packed_d"] = None
        if nonstored:
            # exact per-unit byte offsets from the fetched bit counts
            offs = np.zeros((Bpad * qpl, 2), np.int64)
            nbytes = np.zeros((Bpad * qpl, 2), np.int64)
            cur = 0
            for i, bi in enumerate(range(g0, g1)):
                blen = int(enc_ends[i]) - LANE_HIST
                for q in range(qpl):
                    u = i * qpl + q
                    ul = min(UNIT, max(0, blen - q * UNIT))
                    body_bits, hdr_bits, desc = (int(x) for x in
                                                 meta_np[i, q])
                    if ul <= 0 or not (desc & 3):
                        offs[u] = (cur, cur)
                        continue
                    offs[u, 0] = cur
                    if (desc >> 2) & 1:                # first of block
                        nbytes[u, 0] = (hdr_bits + 7) >> 3
                        cur += nbytes[u, 0]
                    offs[u, 1] = cur
                    nbytes[u, 1] = (body_bits + 7) >> 3
                    cur += nbytes[u, 1]
            gm["flat_packed_d"] = _compact_units(
                [hdr.reshape(Bpad * qpl, -1), body.reshape(Bpad * qpl, -1)],
                nbytes)
            gm["unit_off"] = offs.reshape(Bpad, qpl, 2)
        gm["meta"] = meta_np
        del gm["toks"], gm["flat_d"], gm["lfreqs_d"], gm["dfreqs_d"]

    @clock.stage("stage2")
    def _dispatch_stage2(gm: dict) -> None:
        if quick:
            _dispatch_stage2_quick(gm)
        else:
            _dispatch_stage2_auto(gm)

    def _append_stored(bi: int, q: int, ul: int, blen: int) -> None:
        """A stored block of unit q of lane bi, straight from the input."""
        final = (bi == nblocks - 1) and (q * UNIT + ul == blen)
        pad = (8 - ((stitch.bits + 3) & 7)) & 7
        stitch.append_tokens([(int(final), 1), (0, 2), (0, pad),
                              (ul, 16), (~ul & 0xFFFF, 16)])
        off = LANE_HIST + bi * lane_block + q * UNIT
        stitch.append(vbuf[off:off + ul], ul * 8)

    def _stitch_quick(gm: dict) -> None:
        flat_pk = gm["flat_packed_d"].cpu().numpy() \
            if gm["flat_packed_d"] is not None else None
        packed = totals = None
        if gm["packed_d"] is not None:
            packed = gm["packed_d"].cpu().numpy()      # (Bpad, qpl, out)
            totals = gm["totals_d"].cpu().numpy()      # (Bpad, qpl)
        unit_lens, coded = gm["unit_lens"], gm["coded"]
        # BFINAL on the stream's last unit's 3-bit header when it is coded
        last = None
        if gm["g1"] == nblocks:
            i_last = gm["g1"] - gm["g0"] - 1
            last = (i_last, (int(gm["enc_ends"][i_last]) - LANE_HIST - 1)
                    // UNIT)
        eob = (int(FIXED_LIT_CODES_REV[256]), 7)
        for i, bi in enumerate(range(gm["g0"], gm["g1"])):
            blen = int(gm["enc_ends"][i]) - LANE_HIST
            for q in range(qpl):
                ul = int(unit_lens[i, q])
                if ul == 0:
                    continue
                if not coded[i, q]:
                    _append_stored(bi, q, ul, blen)
                    continue
                stitch.append_tokens([(int(last == (i, q)) | (1 << 1), 3)])
                if flat_pk is not None:
                    bits = int(gm["unit_bits"][i, q])
                    off = int(gm["unit_off"][i, q])
                    stitch.append(flat_pk[off: off + ((bits + 7) >> 3)],
                                  bits)
                else:
                    stitch.append(packed[i, q], int(totals[i, q]))
                stitch.append_tokens([eob])
        gm.pop("flat_packed_d", None)
        gm.pop("packed_d", None)

    def _stitch_auto(gm: dict) -> None:
        meta = gm["meta"]
        flat_pk = gm["flat_packed_d"].cpu().numpy() \
            if gm["flat_packed_d"] is not None else None
        offs = gm.get("unit_off")
        g0, g1 = gm["g0"], gm["g1"]
        enc_ends = gm["enc_ends"]
        # locate the stream-final coded block's first unit (BFINAL patch)
        patch_at = None
        if g1 == nblocks:
            i_last = g1 - g0 - 1
            blen = int(enc_ends[i_last]) - LANE_HIST
            if blen > 0:
                q_last = (blen - 1) // UNIT
                if meta[i_last, q_last, 2] & 3:        # coded, not stored
                    q_first = q_last
                    while q_first > 0 and not (
                            (meta[i_last, q_first, 2] >> 2) & 1):
                        q_first -= 1
                    patch_at = (i_last, q_first)
        blk_bits = 0
        blk_stored_bound = 0
        for i, bi in enumerate(range(g0, g1)):
            blen = int(enc_ends[i]) - LANE_HIST
            for q in range(qpl):
                ul = min(UNIT, max(0, blen - q * UNIT))
                if ul <= 0:
                    continue
                body_bits, hdr_bits, desc = (int(x) for x in meta[i, q])
                if desc & 3 == 0:                      # stored
                    _append_stored(bi, q, ul, blen)
                    continue
                if (desc >> 2) & 1:                    # first of block
                    ho = int(offs[i, q, 0])
                    hp = flat_pk[ho: ho + ((hdr_bits + 7) >> 3)]
                    if patch_at == (i, q):
                        hp = hp.copy()
                        hp[0] |= 1                     # BFINAL
                    stitch.append(hp, hdr_bits)
                    blk_bits = hdr_bits
                    blk_stored_bound = 0
                bo = int(offs[i, q, 1])
                stitch.append(flat_pk[bo: bo + ((body_bits + 7) >> 3)],
                              body_bits)
                blk_bits += body_bits
                blk_stored_bound += 42 + 8 * ul
                eob_nb = (desc >> 4) & 0x1F
                if eob_nb:                             # last of block
                    stitch.append_tokens([((desc >> 9) & 0x7FFF, eob_nb)])
                    blk_bits += eob_nb
                    if _trace_mod.enabled():
                        # a coded block must beat its own stored form + 3
                        audit["groups_checked"] += 1
                        over = blk_bits > blk_stored_bound + 3
                        audit["bit_overruns"] += int(over)
                        trace("deflate block bits_sent=%d stored_bound=%d%s",
                              blk_bits, blk_stored_bound + 3,
                              " OVERRUN" if over else "")
        gm.pop("flat_packed_d", None)

    @clock.stage("stitch", on_device=False)
    def _stitch(gm: dict) -> None:
        if quick:
            _stitch_quick(gm)
        else:
            _stitch_auto(gm)

    # software pipeline over lane groups: stage 1 of the next groups is
    # queued before stage 2 and the stitch of the earlier ones
    inflight: list[dict] = []
    done: list[dict] = []
    for g0 in range(0, nblocks, max_lanes):
        inflight.append(_dispatch_stage1(g0))
        if len(inflight) >= DEPTH:
            gm = inflight.pop(0)
            _dispatch_stage2(gm)
            done.append(gm)
        while len(done) >= DEPTH:
            _stitch(done.pop(0))
    for gm in inflight:
        _dispatch_stage2(gm)
        done.append(gm)
    for gm in done:
        _stitch(gm)
    clock.publish()
    return stitch.getvalue()


def compress_cuda(data, level: int = 6, wbits: int = 15,
                  strategy: int = Z_DEFAULT_STRATEGY,
                  dictionary: bytes | None = None, tune=None,
                  device="cuda") -> bytes:
    """One-shot compression with zlib (wbits 8..15), gzip (16+) or raw
    (-8..-15) framing, on the card unless device="cpu"; byte-identical to
    zlibng_tpu's compress_tpu for every level (-1 and above 9 take L1's
    and L9's engine), strategy 0-4, windowBits, dictionary and `tune`.
    Level 0 and inputs under 1024 bytes go to the host encoder
    (stream/deflate.py), as compress_tpu routes them; it takes no
    `tune`."""
    if not (-15 <= wbits <= 31):
        raise StreamError("invalid windowBits")
    _device(device)
    buf = np.frombuffer(memoryview(bytes(data)), np.uint8)
    if level == 0 or buf.size < 1024:
        return compress_host(buf, level=level, wbits=wbits,
                             strategy=strategy, dictionary=dictionary)
    payload = deflate_payload_cuda(buf, level, strategy, dictionary, tune,
                                   max_dist=effective_window(wbits),
                                   device=device)
    if wbits < 0:
        return payload
    if wbits > 15:
        return (H.build_gzip_header(level=level) + payload
                + H.build_gzip_trailer(crc32(buf), buf.size))
    dictid = adler32(dictionary) if dictionary is not None else None
    head = H.build_zlib_header(wbits=max(wbits, 9), level=level, dictid=dictid)
    return head + payload + H.build_zlib_trailer(adler32(buf))
