"""Block-parallel DEFLATE encoder on the card: the port's main path.

Counterpart of `zlibng_tpu/ops/deflate_tpu.py`:

  host:   slice the input into payload lanes (64-256 KiB), each with the
          previous 32 KiB as read-only history; group up to 2 MiB of lanes
  device: stage 1 — hash/sort/probe (K1, then the deep probes for tuned
          chains beyond 64)/extend/lazy rule per lane [ops/lz77.py], the
          parse walk (K2) [ops/parse.py], per-unit symbol histograms
  device: stage 2, auto — block partition (entropy-estimate DP), exact
          Huffman tables + dynamic headers [ops/huffman.py; one kernel
          per group, csrc/huffman.cu, on the card], block-type
          choice from exact bits, token render [ops/bitpack.py; one
          kernel per render call, csrc/render.cu, on the card] + bit
          pack [ops/bitpack_merge.py; one kernel per pack call,
          csrc/bitpack.cu, on the card]; or the fixed-tree quick path (L1
          and Z_FIXED): each unit's exact static bits from stage 1, the
          same render against the static code tables, pack
  host:   fetch per-unit descriptors and the packed bytes; bit-level
          stitch (stored blocks from the raw input) + zlib/gzip framing

Level 0 and inputs under 1024 bytes run on the host encoder
(stream/deflate.py), as in the reference.

The lane geometry (LANE_BLOCKS, UNIT, the lane-size rule, OUT_BUCKETS)
decides the bytes and equals the reference's, so the output is
byte-identical to `compress_tpu`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace as _trace_mod
from ..checksum.adler32 import adler32
from ..checksum.crc32 import crc32
from ..errors import StreamError
from ..format import headers as H
from ..format.constants import (
    FIXED_LIT_CODES_REV, WINDOW_SIZE, effective_window,
)
from ..huffman.bitpack import pack_bits
from ..stream.deflate import (
    LEVELS, Z_DEFAULT_STRATEGY, Z_FIXED, level_config_from,
)
from ..stream.deflate import compress as compress_host
from ..trace import count, fetch, span, trace, upload
from .bitpack import DEXT, LEXT, code_tables, render_rows
from .bitpack_merge import pack_rows
from .huffman import huff_build
from .lz77 import finalize_tokens, lz77_lane, unit_freqs
from .parse import parse_select_encode

I32 = torch.int32

# bit-accounting audit counters (trees.c:693 compressed_len == bits_sent
# analog; populated only while tracing is enabled)
audit = {"groups_checked": 0, "bit_overruns": 0}
# the last compress call's spans and counters (`trace.py`), filled when
# the call closes: each span name (dotted: `stage2.render`) with its
# seconds summed over the call, device time between CUDA events on a
# card for spans of device work (stage1, stage2 and stage2's parts), the
# host's clock for the others and on the CPU (frame, stitch with its
# fetch, every `.fetch`, the host route's `host_encode`); each counter
# under its name and `.n` (`syncs.n`, `stage2.groups.n`,
# `stage2.redispatch.n`, `compress.calls.host.n`, `compress.calls.card.n`)
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
HMAX = 704               # max dynamic-header tokens (worst-case RLE)
_INF = 1 << 29


def _device(device, who: str = "compress_cuda") -> torch.device:
    """The device an entry point `who` runs on; a CUDA request without a
    card raises (no path carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"{who}: unsupported device {dev}")
    return dev


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


def _payload_units(flat: torch.Tensor, B: int,
                   lane_block: int) -> torch.Tensor:
    """(B, qpl, UNIT) units of the payload of a group's B lanes: a view of
    `flat` where every lane lies in it, else `_lane_slices`' copy (pad
    lanes past the upload read clamped bytes; they select nothing)."""
    if flat.shape[0] >= LANE_HIST + B * lane_block:
        pay = flat[LANE_HIST: LANE_HIST + B * lane_block]
    else:
        pay = _lane_slices(flat, LANE_HIST, lane_block, lane_block, B)
    return pay.reshape(B, lane_block // UNIT, UNIT)


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
        C = code_tables(flat.device)
        fb = ((lfreqs * (C["fll"] + C["lext"])).sum(-1, dtype=I32)
              + (dfreqs * (C["fdl"] + C["dext"])).sum(-1, dtype=I32))
        return toks, fb, None
    return toks, lfreqs, dfreqs


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
    lfreq_u (B, qpl, 286); dfreq_u (B, qpl, 30); unit_lens (B, qpl).
    Spans: stage2.partition, stage2.huffman, stage2.render, stage2.pack."""
    B = pay.shape[0]
    dev = pay.device
    G = B * qpl
    C = code_tables(dev)
    with span("stage2.partition", dev):
        (lfreq_n, ndf, nsto, extra_n, sta_n, assign, first_q,
         last_q) = _partition(lfreq_u, dfreq_u, unit_lens, qpl, C)

    # ---- exact build for the qpl assigned blocks ------------------------
    with span("stage2.huffman", dev):
        lfreq_b = lfreq_n.gather(1, assign[..., None].expand(B, qpl, 286))
        dfreq_b = ndf.gather(1, assign[..., None].expand(B, qpl, 30))
        (llen_b, lcode_b, dlen_b, dcode_b, hdr_lo_b, hdr_nb_b,
         hdr_bits_b) = huff_build(lfreq_b.reshape(G, 286),
                                  dfreq_b.reshape(G, 30), 4)
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

    with span("stage2.render", dev):
        # ---- per-unit tables + body render ------------------------------
        dynsel = (btype_u == 2)[:, None]
        z2 = torch.zeros((G, 2), dtype=I32, device=dev)
        lt_u = torch.where(dynsel, torch.cat([llen_b, z2], 1), C["fl288"])
        lc_u = torch.where(dynsel, torch.cat([lcode_b, z2], 1), C["flc"])
        dt_u = torch.where(dynsel, dlen_b, C["fdl"])
        dc_u = torch.where(dynsel, dcode_b, C["fdc"])
        body = render_rows(pay, tlq, tdq, seq, lt_u, lc_u, dt_u, dc_u,
                           demote=True)

        # ---- per-unit header tokens (first-of-block only) ---------------
        first_q = first_q.reshape(G)
        last_q = last_q.reshape(G)
        is_dyn_hdr = (first_q & (btype_u == 2))[:, None]
        is_sta_hdr = first_q & (btype_u == 1)
        hlo_u = torch.where(is_dyn_hdr, hdr_lo_b, 0)
        hnb_u = torch.where(is_dyn_hdr, hdr_nb_b, 0)
        # static header: a single 3-bit token in slot 0 (BFINAL patched on
        # host)
        hlo_u[:, 0] = torch.where(is_sta_hdr, 2, hlo_u[:, 0])
        hnb_u[:, 0] = torch.where(is_sta_hdr, 3, hnb_u[:, 0])

        # ---- per-unit descriptor: btype | first | last | eob ------------
        eob_code = torch.where(btype_u == 2, lcode_b[:, 256], C["flc"][256])
        eob_nb = torch.where(btype_u == 2, llen_b[:, 256], 7)
        has_eob = last_q & (btype_u != 0)
        desc = (btype_u | (first_q.to(I32) << 2) | (last_q.to(I32) << 3)
                | (torch.where(has_eob, eob_nb, 0) << 4)
                | (torch.where(has_eob, eob_code, 0) << 9))

    with span("stage2.pack", dev):
        body_packed, body_bits = pack_rows(*body, out_bytes)
        hdr_packed, hdr_bits = pack_rows(
            hlo_u, torch.zeros_like(hlo_u), hnb_u, HDR_OUT)
        meta = torch.stack([body_bits, hdr_bits, desc.to(I32)], -1).to(I32)
    return (body_packed.reshape(B, qpl, out_bytes),
            hdr_packed.reshape(B, qpl, HDR_OUT), meta.reshape(B, qpl, 3))


def _partition(lfreq_u, dfreq_u, unit_lens, qpl: int, C: dict):
    """The node pyramid of each lane's qpl units, their estimated costs and
    the DP's optimal contiguous power-of-2 partition, walked down to each
    unit's block. Returns (lfreq_n (B, nodes, 286) with one EOB per node,
    ndf (B, nodes, 30), nsto, extra_n and sta_n (B, nodes): stored bits,
    extra bits and static bits of each node; assign (B, qpl) int64: each
    unit's node; first_q, last_q (B, qpl) bool: first and last unit of its
    block)."""
    B = lfreq_u.shape[0]
    dev = lfreq_u.device
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
    # the estimate's round trip through the host (see _est_dyn)
    est_dyn_n = upload(_est_dyn(
        torch.from_numpy(fetch(torch.cat([lfreq_n, ndf], -1))),
        torch.from_numpy(LEXT), torch.from_numpy(DEXT)), dev)
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
    units = 1 << lv_of                         # units in my block
    first_q = (q & (units - 1)) == 0
    last_q = (q & (units - 1)) == units - 1
    return lfreq_n, ndf, nsto, extra_n, sta_n, assign, first_q, last_q


def _stage2_auto(flat, tok_len, tok_dist, sel, lfreqs, dfreqs, enc_ends,
                 lane_block: int, out_bytes: int):
    """Stage 2 over a lane group: tables, headers, partition and block
    types on the device; returns (body (B, qpl, out_bytes) uint8,
    hdr (B, qpl, HDR_OUT) uint8, meta (B, qpl, 3) int32 =
    [body_bits, hdr_bits, desc])."""
    qpl = lane_block // UNIT
    B = tok_len.shape[0]
    pay = _payload_units(flat, B, lane_block)
    tlq, tdq, seq = (t[:, LANE_HIST:].view(B, qpl, UNIT)
                     for t in (tok_len, tok_dist, sel))
    qoff = torch.arange(qpl, dtype=I32, device=flat.device) * UNIT
    unit_lens = (enc_ends.to(I32)[:, None] - LANE_HIST - qoff).clamp(0, UNIT)
    return _lane_stage2_auto(pay, tlq, tdq, seq, lfreqs, dfreqs, unit_lens,
                             out_bytes, qpl)


def _stage2_fixed(flat, tok_len, tok_dist, sel, lane_block: int,
                  out_bytes: int, demote: bool):
    """Fixed-tree stage 2 over a lane group (the deflate_quick design
    point): the render against the static code tables, no tree build or
    frequency fetch, then the pack. `demote` turns on the cost-model match
    demotion (Z_FIXED); L1 emits every match. Returns (packed (B, qpl,
    out_bytes) uint8, totals (B, qpl) int32 body bits)."""
    qpl = lane_block // UNIT
    B = tok_len.shape[0]
    dev = flat.device
    pay = _payload_units(flat, B, lane_block)
    C = code_tables(dev)
    with span("stage2.render", dev):
        fields = render_rows(
            pay, *(t[:, LANE_HIST:].view(B, qpl, UNIT)
                   for t in (tok_len, tok_dist, sel)),
            C["fl288"], C["flc"], C["fdl"], C["fdc"], demote=demote)
    with span("stage2.pack", dev):
        packed, totals = pack_rows(*fields, out_bytes)
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


def _header_tokens_to_arrays(tokens: list[tuple[int, int]]):
    """Header (value, nbits) pairs as padded (HMAX,) lo/hi/nb arrays."""
    if len(tokens) > HMAX:
        raise ValueError(f"{len(tokens)} header tokens, more than {HMAX}")
    lo = np.zeros(HMAX, np.uint32)
    hi = np.zeros(HMAX, np.uint32)
    nb = np.zeros(HMAX, np.int32)
    for i, (v, n) in enumerate(tokens):
        lo[i] = v & 0xFFFFFFFF
        hi[i] = (v >> 32) & 0xFFFFFFFF
        nb[i] = n
    return lo, hi, nb


def _extra_bits_batch(lfreqs: np.ndarray, dfreqs: np.ndarray) -> np.ndarray:
    """Length and distance extra bits of each row's symbols: (U, 286),
    (U, 30) int64 -> (U,) int64."""
    return lfreqs @ LEXT.astype(np.int64) + dfreqs @ DEXT.astype(np.int64)


def _est_block_bits_batch(lfreqs: np.ndarray, dfreqs: np.ndarray,
                          extra_v: np.ndarray) -> np.ndarray:
    """Entropy + extra-bits + header-model estimate of a dynamic block for
    each row: (U, 286), (U, 30) and the rows' `_extra_bits_batch` -> (U,)
    float64, in the reference's numpy order of operations (the sharded
    path's stored pre-pass)."""
    bits = extra_v.astype(np.float64)
    for f in (lfreqs, dfreqs):
        tot = f.sum(axis=1, keepdims=True).astype(np.float64)
        fv = f.astype(np.float64)
        safe = np.maximum(fv, 1.0)
        ent = np.where(f > 0,
                       fv * (np.log2(np.maximum(tot, 1.0)) - np.log2(safe)),
                       0.0)
        bits += ent.sum(axis=1)
    used = (lfreqs > 0).sum(axis=1) + (dfreqs > 0).sum(axis=1)
    return bits + 3 + 14 + 57 + 5 * used


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
    below 1 and above 9 take L1's and L9's engine. The call's spans and
    counters fill stage_seconds."""
    dev = _device(device)
    with _trace_mod.call("compress", _publish):
        return _deflate_payload(buf, level, strategy, dictionary, tune,
                                max_dist, dev)


def _deflate_payload(buf, level, strategy, dictionary, tune, max_dist,
                     dev) -> bytes:
    """deflate_payload_cuda's body: the frame's set-up, then the lane
    groups' software pipeline (stage 1 and stage 2 on the device, the
    stitch on the host)."""
    with span("frame"):
        lc = level_config_from(tune) if tune is not None \
            else LEVELS[max(1, min(9, level))]
        s1_strategy = strategy if strategy in (1, 2, 3) else 0
        # fixed-tree quick path (deflate_quick, L1 in zlib-ng's
        # configuration_table, deflate.c:142-152): Z_FIXED at any level,
        # and L1 with the default strategy
        quick = strategy == Z_FIXED or (level == 1 and strategy == 0)
        n = buf.size
        # lane geometry by input size: minimize processed positions
        # (history prefix + zero tail), ties to bigger lanes
        lane_block = min(LANE_BLOCKS, key=lambda lb: (
            -(-n // lb) * (lb + LANE_HIST), -lb))
        qpl = lane_block // UNIT
        max_lanes = max(1, GROUP_BYTES // lane_block)
        nblocks = max(1, -(-n // lane_block))

        # virtual buffer with 32K zero/dict prefix so every lane slices
        # uniformly
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

    def _group_flat(g0: int, B: int) -> torch.Tensor:
        # the group's lanes plus history, zero-padded to the upload bucket
        Bup = next(b for b in _UP_BUCKETS if b >= B)
        base = g0 * lane_block
        flat = vbuf_d[base: base + LANE_HIST + B * lane_block]
        if Bup != B:
            flat = torch.cat([flat, flat.new_zeros((Bup - B) * lane_block)])
        return flat

    def _dispatch_stage1(g0: int) -> dict:
        g1 = min(g0 + max_lanes, nblocks)
        B = g1 - g0
        Bpad = 1 << (B - 1).bit_length()
        with span("stage1", dev, group=g0 // max_lanes):
            flat_d = _group_flat(g0, B)
            enc_ends = np.full(Bpad, LANE_HIST, np.int32)
            hist_valids = np.zeros(Bpad, np.int32)
            for i, bi in enumerate(range(g0, g1)):
                enc_ends[i] = LANE_HIST + min(lane_block,
                                              n - bi * lane_block)
                hist_valids[i] = first_hist_valid if bi == 0 else 0
            enc_ends_d = upload(enc_ends, dev)
            toks, a_d, b_d = _stage1(
                flat_d, enc_ends_d, upload(hist_valids, dev),
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
        Bpad = gm["Bpad"]
        toks, flat_d = gm["toks"], gm["flat_d"]
        fb = fetch(gm["fb_d"]).astype(np.int64)          # (Bpad, qpl)
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
                gm["packed_d"], gm["totals_d"] = _stage2_fixed(
                    *args, demote=True)
            else:
                nbytes = np.where(coded, (fb + 7) >> 3, 0)
                gm["unit_off"] = (np.cumsum(nbytes) - nbytes.reshape(-1)) \
                    .reshape(Bpad, qpl)
                gm["unit_bits"] = fb
                packed, _ = _stage2_fixed(*args, demote=False)
                with span("stage2.pack", dev):
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

        count("stage2.groups")
        body, hdr, meta = run(out_bytes)
        meta_np = fetch(meta)                          # (Bpad, qpl, 3)
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
        redo = need_bits > (out_bytes - 8) * 8
        count("stage2.redispatch", int(redo))
        if redo:
            out_bytes = next((ob for ob in OUT_BUCKETS
                              if need_bits <= (ob - 8) * 8), OUT_BUCKETS[-1])
            trace("stage2-auto bucket overflow: redispatch at %d", out_bytes)
            body, hdr, meta = run(out_bytes)
            meta_np = fetch(meta)
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
            with span("stage2.pack", dev):
                gm["flat_packed_d"] = _compact_units(
                    [hdr.reshape(Bpad * qpl, -1),
                     body.reshape(Bpad * qpl, -1)], nbytes)
            gm["unit_off"] = offs.reshape(Bpad, qpl, 2)
        gm["meta"] = meta_np
        del gm["toks"], gm["flat_d"], gm["lfreqs_d"], gm["dfreqs_d"]

    def _dispatch_stage2(gm: dict) -> None:
        with span("stage2", dev, group=gm["g0"] // max_lanes):
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
        flat_pk = fetch(gm["flat_packed_d"]) \
            if gm["flat_packed_d"] is not None else None
        packed = totals = None
        if gm["packed_d"] is not None:
            packed = fetch(gm["packed_d"])             # (Bpad, qpl, out)
            totals = fetch(gm["totals_d"])             # (Bpad, qpl)
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
        flat_pk = fetch(gm["flat_packed_d"]) \
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

    def _stitch(gm: dict) -> None:
        with span("stitch", group=gm["g0"] // max_lanes):
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
    `tune`. Either route opens the call's root: the counter
    `compress.calls.host` or `compress.calls.card` says which ran, and
    the host route's one span, `host_encode`, waits on no card."""
    if not (-15 <= wbits <= 31):
        raise StreamError("invalid windowBits")
    _device(device)
    buf = np.frombuffer(memoryview(bytes(data)), np.uint8)
    with _trace_mod.call("compress", _publish):
        if level == 0 or buf.size < 1024:
            count("compress.calls.host")
            with span("host_encode"):
                return compress_host(buf, level=level, wbits=wbits,
                                     strategy=strategy,
                                     dictionary=dictionary)
        count("compress.calls.card")
        payload = deflate_payload_cuda(buf, level, strategy, dictionary,
                                       tune, max_dist=effective_window(wbits),
                                       device=device)
        with span("frame"):
            if wbits < 0:
                return payload
            if wbits > 15:
                return (H.build_gzip_header(level=level) + payload
                        + H.build_gzip_trailer(crc32(buf), buf.size))
            dictid = adler32(dictionary) if dictionary is not None else None
            head = H.build_zlib_header(wbits=max(wbits, 9), level=level,
                                       dictid=dictid)
            return head + payload + H.build_zlib_trailer(adler32(buf))


def _publish(call) -> None:
    """Refill stage_seconds from a compress call's record."""
    stage_seconds.clear()
    stage_seconds.update(stage1=0.0, stage2=0.0, stitch=0.0)
    stage_seconds.update(call.totals())
    stage_seconds.update({k + ".n": v for k, v in call.counts.items()})
