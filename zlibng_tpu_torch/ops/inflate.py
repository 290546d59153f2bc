"""Batch DEFLATE decoder on the card: the port's device decode path.

Counterpart of `zlibng_tpu/ops/inflate_tpu.py`. Decoding is two array
phases instead of a byte-serial state machine:

  phase A — token resolution. For every bit position of a Huffman block,
      speculatively decode one token with flat LUTs built on the device
      from the block's canonical code description (`_build_flat_luts`):
      (symbol, length, dist, bits consumed) per position. The true token
      starts are the orbit of the block's first bit under
      p -> p + consumed(p): the parse walk K2 (`ops/parse.py:parse_select`,
      the CUDA kernel `csrc/parse.cu` on the card). EOB and invalid
      positions step by 1 << 26, so the walk ends there and the block's
      end falls out of the selected set.

  phase B — LZ77 reconstruction. Tokens (literal / match / stored run)
      expand to per-output-byte source pointers; pointer doubling
      (ptr = ptr[ptr] to a fixpoint) resolves every chain of overlapping
      copies to a literal, stored or dictionary byte, then one gather makes
      the output.

The host keeps the format's serial parts: block headers, dynamic table
parsing and stored blocks (stream/inflate_serial.py). A stream the batch
path cannot or should not decode (corruption, for zlib's exact error text,
or a block too large for the biggest lane) reruns on that serial decoder.

Every array that decides a wave, a fallback or a byte is the reference's:
`_CB_BUCKETS`, `_BIG`, T_CAP = N // 4, the K_* kinds, and the clamps of
every gather. uint32 words are held in int64 and shifted there; a clamped
or dropped scatter of the reference writes to one scratch slot past the
end, which is then cut off.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import DataError as InflateError
from ..stream import inflate_serial as _serial
from ..stream.inflate_serial import (
    _S_BLOCK_HEADER, _S_HUFF, _S_STORED, NEED_INPUT, RawInflater,
)
from .. import _build
from .. import trace as _trace
from ..trace import count, fetch, item, span, trace, upload
from .bitpack import code_tables
from .deflate import _device
from .parse import parse_select

I32 = torch.int32
I64 = torch.int64

# phase A token kinds
K_LIT = 0
K_MATCH = 1
K_EOB = 2
K_INVALID = 3
# phase B token kinds (host-side accumulation)
B_LIT = 0
B_MATCH = 1
B_STORED = 2

# lane size buckets (compressed bytes per lane); a block larger than the
# biggest falls back to the serial decoder
_CB_BUCKETS = (1 << 11, 1 << 14, 1 << 15, 1 << 17)
_DPAD = 1 << 15          # dictionary/window prefix region in phase B
_BIG = 1 << 26           # chain-terminating step


# `launches`: flat-LUT kernel launches so far (`_build.launches`)
__getattr__ = _build.launch_count("flat_luts")

# Above this size, an unindexed single stream decodes on the host: without
# known segment boundaries the device path round-trips once per DEFLATE
# block (the boundary is data-dependent). Indexed and multi-segment inputs
# batch many blocks per dispatch and stay on the device.
_DEVICE_SINGLE_MAX = 1 << 20

# Routing/result counters, counted where the reference counts them
stats = {"device_ok": 0, "fallback": 0, "host_routed": 0, "mesh_ok": 0,
         "error": 0}
# the last device decode, filled from its spans and counters (`trace.py`)
# when it closes: waves (host passes over the live segments), phase A
# dispatches (one per lane bucket per wave, one K2 launch each on the
# card), phase B dispatches, host-clock seconds of phase A (upload,
# dispatch and the fetch that waits for it), of phase B (the same) and of
# the whole wave engine (`total_s`), and why it gave the stream up to the
# serial decoder (None when it did not). Beside them, every other span as
# `<name>_s` (phase A's parts `phase_a.luts_s`, `phase_a.steps_s`,
# `phase_a.k2_s`, `phase_a.compact_s` in device time on a card; the waits
# `phase_a.fetch_s`, `phase_b.fetch_s`, `decode.fetch_s` on the host's
# clock) and every counter under its name: `syncs`, `sync_bytes`,
# `phase_a_lanes` (real lanes dispatched), `phase_a_retries` (lanes sent
# again in a bigger bucket), `k2_lanes` and `k2_positions` (B and B * N of
# each phase A walk, summed)
decode_stats = {"waves": 0, "phase_a": 0, "phase_b": 0, "phase_a_s": 0.0,
                "phase_b_s": 0.0, "total_s": 0.0, "fallback_cause": None}
_COUNTERS = ("waves", "phase_a", "phase_b", "phase_a_lanes",
             "phase_a_retries", "k2_lanes", "k2_positions")


def _publish(call) -> None:
    """Refill decode_stats from a decode call's record."""
    decode_stats.clear()
    decode_stats.update(dict.fromkeys(_COUNTERS, 0), phase_a_s=0.0,
                        phase_b_s=0.0)
    decode_stats.update({k + "_s": v for k, v in call.totals().items()
                         if k != call.name})
    decode_stats.update(call.counts)
    decode_stats.update(total_s=call.spans[0].host_s, fallback_cause=None)


class _Fallback(Exception):
    """Internal: this stream needs the serial conformance path."""


# ---------------------------------------------------------------------------
# phase A — batched speculative token resolution
# ---------------------------------------------------------------------------
def _build_flat_luts(tabs: torch.Tensor, masks: torch.Tensor,
                     lut_cap: int) -> torch.Tensor:
    """Flat LUTs from the canonical description (_canon_tables packing,
    (B, 48 + nsyms) int32) and each lane's peek mask (B,) int32: entry p
    of lane b decodes the peek value p. With w the popcount of the mask,
    the code length is the first ln <= w whose canonical offset of p's
    top w reversed bits lies in the range of length ln; a symtab gather
    gives the symbol. Entries are sym << 4 | len, -16 invalid: the host
    LUT layout. Returns (B, lut_cap) int32.

    CUDA tensors: one launch of the hand-written kernel `csrc/flat_luts.cu`
    on the current stream (or it raises); CPU tensors: the plain version,
    `_build_flat_luts_plain`; any other device raises. The two are equal
    entry for entry for every mask of popcount <= 15 and any table from
    `_canon_tables`, padding lanes' zero tables with mask 0 included; phase
    A passes only masks (1 << w) - 1 with w <= 15."""
    if tabs.is_cuda:
        return _build_flat_luts_cuda(tabs, masks, lut_cap)
    if tabs.device.type != "cpu":
        raise ValueError(
            f"_build_flat_luts: unsupported device {tabs.device}")
    return _build_flat_luts_plain(tabs, masks, lut_cap)


def _build_flat_luts_cuda(tabs: torch.Tensor, masks: torch.Tensor,
                          lut_cap: int) -> torch.Tensor:
    """Runs the kernel on CUDA tensors: one launch on the current stream,
    checking only what needs no wait for the card."""
    if tabs.dim() != 2 or tabs.shape[1] <= 48 \
            or masks.shape != (tabs.shape[0],):
        raise ValueError("flat_luts kernel: tables must be (B, 48 + nsyms) "
                         "with nsyms >= 1 and masks (B,)")
    if not 1 <= lut_cap <= 1 << 15:
        raise ValueError(f"flat_luts kernel: lut_cap {lut_cap} is not in "
                         f"[1, 32768]")
    B = tabs.shape[0]
    if B > 65535:
        raise ValueError(f"flat_luts kernel: {B} lanes, at most 65535")
    dev = _build.check_cuda("flat_luts kernel", tabs, masks)
    out = torch.empty((B, lut_cap), dtype=I32, device=dev)
    if B:
        _build.launch("flat_luts", dev, tabs, masks, out, B,
                      tabs.shape[1] - 48, lut_cap)
    return out


def _build_flat_luts_plain(tabs: torch.Tensor, masks: torch.Tensor,
                           lut_cap: int) -> torch.Tensor:
    """The plain version, on any device: for every peek value the code
    length is found by 15 canonical-range compares, then one symtab gather
    gives the symbol."""
    counts = tabs[:, 0:16]
    first = tabs[:, 16:32]
    index = tabs[:, 32:48]
    symtab = tabs[:, 48:]
    nsyms = symtab.shape[1]
    B = tabs.shape[0]
    dev = tabs.device
    p = torch.arange(lut_cap, dtype=I32, device=dev)[None, :]
    # bit-reverse the low 15 bits of p (the first-received bit becomes the
    # code's MSB)
    rev = p
    rev = ((rev & 0x5555) << 1) | ((rev >> 1) & 0x5555)
    rev = ((rev & 0x3333) << 2) | ((rev >> 2) & 0x3333)
    rev = ((rev & 0x0F0F) << 4) | ((rev >> 4) & 0x0F0F)
    rev = ((rev & 0x00FF) << 8) | ((rev >> 8) & 0x00FF)
    rev15 = rev >> 1                                   # 16-bit rev -> 15
    bit = torch.arange(32, dtype=I32, device=dev)
    w = ((masks[:, None] >> bit) & 1).sum(1, dtype=I32)[:, None]  # popcount
    rev_w = rev15 >> (15 - w)
    best_l = torch.zeros((B, lut_cap), dtype=I32, device=dev)
    best_off = torch.zeros((B, lut_cap), dtype=I32, device=dev)
    found = torch.zeros((B, lut_cap), dtype=torch.bool, device=dev)
    for ln in range(1, 16):
        c = rev_w >> (w - ln).clamp(0, 15)
        off = c - first[:, ln:ln + 1]
        valid = (off >= 0) & (off < counts[:, ln:ln + 1]) & (ln <= w)
        take = valid & ~found
        best_l = torch.where(take, ln, best_l)
        best_off = torch.where(take, index[:, ln:ln + 1] + off, best_off)
        found = found | take
    sym = symtab.gather(1, best_off.clamp(0, nsyms - 1).long())
    return torch.where(found, (sym << 4) | best_l, -16).to(I32)


def _phase_a_steps(comp, byte_starts, lit_tabs, dist_tabs, start_bits,
                   lit_masks, dist_masks, cb, lit_cap=1 << 15,
                   dist_cap=1 << 15):
    """Phase A up to the walk: every bit position of every lane decoded as
    one token. Returns (step (B, N) int32, bounds (B, 2) int32, kind
    (B, N) int32, packed (B, N) int32, tend (B, N) int32) with N = 8 * cb:
    the walk's input, and each position's token kind, payload (match:
    length << 16 | dist; literal: symbol; the uint32 bits of the
    reference's aux) and end bit.

    comp (C,) uint8 is the whole padded stream; lanes of cb bytes are
    sliced at byte_starts (B,) (clamped to fit, as a dynamic slice is);
    start_bits (B,) is each lane's first symbol bit. Peeks are 32-bit word
    reads (w32[p >> 3] >> (p & 7)): the word at a symbol's byte covers its
    code (<= 15 bits) plus length extras (<= 5) from any bit offset, and
    the distance code and extras are read through two word gathers."""
    dev = comp.device
    with span("phase_a.luts", dev):
        lit_luts = _build_flat_luts(lit_tabs, lit_masks, lit_cap)
        dist_luts = _build_flat_luts(dist_tabs, dist_masks, dist_cap)
    with span("phase_a.steps", dev):
        return _decode_every_bit(comp, byte_starts, lit_luts, dist_luts,
                                 start_bits, lit_masks, dist_masks, cb)


def _decode_every_bit(comp, byte_starts, lit_luts, dist_luts, start_bits,
                      lit_masks, dist_masks, cb):
    """_phase_a_steps after the LUT build: one token decoded at every bit
    position of every lane."""
    dev = comp.device
    CB = cb
    C = comp.shape[0]
    lb_idx = (byte_starts.long().clamp(0, C - CB)[:, None]
              + torch.arange(CB, dtype=I64, device=dev)[None, :])
    lane_bytes = comp[lb_idx]
    N = CB * 8
    C = code_tables(dev)
    LB, DB = C["lbase"], C["dbase"]

    # LE 32-bit word at every byte offset, held in int64 (uint32 values)
    lb = F.pad(lane_bytes.long(), (0, 8))
    w32 = (lb[:, :CB] | (lb[:, 1:CB + 1] << 8) | (lb[:, 2:CB + 2] << 16)
           | (lb[:, 3:CB + 3] << 24))                       # (B, CB)
    CBP = CB + 2
    w32p = F.pad(w32, (0, 2))                               # guard gathers

    pos = torch.arange(N, dtype=I32, device=dev)[None, :]
    # dense per-bit window: each byte's word at its 8 bit offsets. The
    # reference casts this uint32 to int32; every use below masks to at
    # most 20 low bits, where the two agree, so it stays non-negative here
    wd = w32.repeat_interleave(8, dim=1) >> (pos & 7).long()

    # literal/length decode at every position
    ent = lit_luts.gather(1, wd & lit_masks.long()[:, None])
    nb = ent & 15
    sym = ent >> 4
    invalid = ent < 0
    is_eob = sym == 256
    is_len = sym > 256
    invalid = invalid | (sym > 285)

    # length base/extra: sym 257..285 -> LENGTH_BASE / extra-bit count;
    # extras sit at bit nb of the same window
    i_l = (sym - 257).clamp(0, 28)
    e_l = torch.where(i_l >= 28, 0, ((i_l - 4) >> 2).clamp(0, 5))
    lext = ((wd >> nb.long()) & ((1 << e_l.long()) - 1)).to(I32)
    length = LB[i_l.long()] + lext

    # distance decode at the post-length position: one word gather for the
    # code, one for its extras (e_d <= 13 can cross the first word)
    q = pos + nb + e_l
    wq = w32p.gather(1, (q >> 3).clamp(max=CBP - 1).long())
    dpk = (wq >> (q & 7).long()) & dist_masks.long()[:, None]
    dent = dist_luts.gather(1, dpk)
    dnb = dent & 15
    dsym = dent >> 4
    invalid = invalid | (is_len & ((dent < 0) | (dsym > 29)))
    i_d = dsym.clamp(0, 29)
    e_d = ((i_d - 2) >> 1).clamp(0, 13)
    q2 = q + dnb
    wq2 = w32p.gather(1, (q2 >> 3).clamp(max=CBP - 1).long())
    dext = ((wq2 >> (q2 & 7).long()) & ((1 << e_d.long()) - 1)).to(I32)
    dist = DB[i_d.long()] + dext

    consumed = torch.where(is_len, nb + e_l + dnb + e_d, nb)
    step = torch.where(invalid | is_eob, _BIG,
                       consumed.clamp(min=1)).to(I32).contiguous()
    bounds = torch.stack([start_bits.to(I32),
                          torch.full_like(start_bits, N, dtype=I32)],
                         1).contiguous()
    kind = torch.where(invalid, K_INVALID,
                       torch.where(is_eob, K_EOB,
                                   torch.where(is_len, K_MATCH, K_LIT)))
    # packed payload: match -> length << 16 | dist (both fit 16 bits);
    # literal -> symbol
    packed = torch.where(is_len, (length << 16) | dist, sym)
    tend = pos + consumed
    return step, bounds, kind.to(I32), packed.to(I32), tend.to(I32)


def _phase_a(comp, byte_starts, lit_tabs, dist_tabs, start_bits, lit_masks,
             dist_masks, cb, lit_cap=1 << 15, dist_cap=1 << 15):
    """Phase A of one wave (arguments as _phase_a_steps'): the walk over
    the bit steps (K2 on the card), then in-order compaction of the walk's
    tokens. Returns per-lane token arrays (kind int8 and packed aux int32,
    the reference's uint32 bits, both (B, T_CAP) with T_CAP = N // 4),
    counts (B,), and the first EOB/invalid token's index, kind and end bit
    (B,) each, so the host fetches scalars, not the (B, T_CAP) end array."""
    step, bounds, kind, packed, tend = _phase_a_steps(
        comp, byte_starts, lit_tabs, dist_tabs, start_bits, lit_masks,
        dist_masks, cb, lit_cap, dist_cap)
    B, N = step.shape
    dev = comp.device
    with span("phase_a.k2", dev):
        sel = parse_select(step, bounds)
    count("k2_lanes", B)
    count("k2_positions", B * N)
    with span("phase_a.compact", dev):
        return _compact_tokens(sel, kind, packed, tend)


def _compact_tokens(sel, kind, packed, tend):
    """The rest of _phase_a after the walk: its selected tokens in order,
    and each lane's first EOB/invalid token."""
    B, N = sel.shape
    T_CAP = N // 4
    # in-order compaction: rank-scatter into fixed-size token arrays; the
    # reference drops ranks at or past T_CAP, here they land in a scratch
    # column T_CAP that is cut off
    rank = sel.cumsum(1) - 1
    sidx = torch.where(sel, rank, T_CAP).clamp(max=T_CAP)

    def compact(v):
        out = torch.zeros((B, T_CAP + 1), dtype=v.dtype, device=v.device)
        return out.scatter_(1, sidx, v)[:, :T_CAP]

    tok_kind = compact(kind.to(torch.int8))
    tok_aux = compact(packed)
    tok_end = compact(tend)
    ntok = sel.sum(1, dtype=I32)
    # first EOB/invalid token per lane, resolved on the device
    tk = tok_kind.to(I32)
    iota = torch.arange(T_CAP, dtype=I32, device=tk.device)[None, :]
    spec_idx = torch.where(tk >= K_EOB, iota, T_CAP).amin(1)
    safe = spec_idx.clamp(max=T_CAP - 1).long()[:, None]
    spec_kind = tk.gather(1, safe)[:, 0]
    spec_end = tok_end.gather(1, safe)[:, 0]
    return tok_kind, tok_aux, ntok, spec_idx, spec_kind, spec_end


# ---------------------------------------------------------------------------
# phase B — LZ77 reconstruction via pointer doubling
# ---------------------------------------------------------------------------
def _phase_b_multi(kinds, auxs, olens, comp, dictv, dict_lens, wsize: int,
                   out_cap: int):
    """Phase B of S segments at once (the reference's _phase_b, vmapped).
    kinds/auxs/olens (S, T) int32 tokens (B_LIT value / B_MATCH dist /
    B_STORED comp byte offset; olen = bytes emitted); comp (C,) uint8 padded
    compressed stream (stored runs); dictv (32768,) uint8 right-aligned
    dictionary; dict_lens (S,). Returns (out (S, out_cap) uint8, bad (S,)
    bool: a distance reaching before the dictionary or past the window)."""
    S, T = kinds.shape
    dev = kinds.device
    real = olens > 0
    csum = olens.long().cumsum(1)
    starts = _DPAD + csum - olens                    # exclusive prefix sum
    total = _DPAD + csum[:, -1:]

    # per-output-byte token id: scatter-add block starts (starts past the
    # end go to scratch column out_cap), prefix-sum
    at = torch.where(real, starts, out_cap).clamp(max=out_cap)
    inc = torch.zeros((S, out_cap + 1), dtype=I32, device=dev)
    inc.scatter_add_(1, at, torch.ones_like(at, dtype=I32))
    tid = inc[:, :out_cap].cumsum(1) - 1
    tidc = tid.clamp(0, T - 1)
    j = torch.arange(out_cap, dtype=I64, device=dev)[None, :]
    k = kinds.gather(1, tidc)
    a = auxs.long().gather(1, tidc)
    st = starts.gather(1, tidc)
    in_data = (j >= _DPAD) & (tid >= 0) & (j < total)
    ofs = j - st

    is_m = in_data & (k == B_MATCH)
    src = j - a
    bad = is_m & ((src < _DPAD - dict_lens.long()[:, None]) | (a > wsize))

    v_sto = comp[(a + ofs).clamp(0, comp.shape[0] - 1)].to(I32)
    # dictv is right-aligned in a 32768-byte buffer and _DPAD == 32768, so
    # output position j < _DPAD maps one-to-one onto dictv[j]
    v_dict = dictv[j.clamp(0, dictv.shape[0] - 1)].to(I32)
    val = torch.where(j < _DPAD, v_dict,
                      torch.where(k == B_LIT, a.to(I32), v_sto))

    ptr = torch.where(is_m, src.clamp(0, out_cap - 1), j)
    # pointer doubling to the fixpoint: one convergence read per round
    while True:
        nxt = ptr.gather(1, ptr)
        if not item((nxt != ptr).any()):
            break
        ptr = nxt
    out = val.gather(1, ptr).to(torch.uint8)
    return out, bad.any(1)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------
class _Cursor:
    """Per-segment decode state for the wave engine."""

    __slots__ = ("pos", "end_bit", "toks", "done", "bucket", "total_out",
                 "final")

    def __init__(self, start_bit: int, end_bit: int | None):
        self.pos = start_bit         # absolute bit position in comp
        self.end_bit = end_bit       # segment bound (full-flush boundary)
        self.toks = []               # list of (kind, aux, olen) np arrays
        self.done = False
        self.bucket = 0
        self.total_out = 0
        self.final = False           # current block's BFINAL


def _canon_tables(lengths: np.ndarray, nsyms: int) -> tuple[np.ndarray, int]:
    """Canonical-code description of one Huffman table, packed for the
    device LUT builder: [counts(16) | first(16) | index(16) | symtab] int32.
    symtab = symbols sorted by (length, symbol); first/index are the RFC
    1951 3.2.2 canonical first code and symbol base per length. Returns
    (packed (48 + nsyms,) int32, max_len)."""
    ln = lengths[:nsyms]
    counts = np.bincount(ln, minlength=16)[:16].astype(np.int64)
    counts[0] = 0
    first = np.zeros(16, np.int64)
    index = np.zeros(16, np.int64)
    code = 0
    idx = 0
    for bits in range(1, 16):
        first[bits] = code
        index[bits] = idx
        idx += counts[bits]
        code = (code + counts[bits]) << 1
    used = np.nonzero(ln > 0)[0]
    order = used[np.argsort(ln[used], kind="stable")]
    symtab = np.zeros(nsyms, np.int64)
    symtab[:order.size] = order
    w = int(ln.max()) if used.size else 1
    return np.concatenate([counts, first, index, symtab]).astype(np.int32), w


@functools.lru_cache(maxsize=4)
def _fixed_canon():
    """Canonical descriptions of the RFC fixed trees."""
    lit = np.zeros(288, np.int32)
    lit[0:144] = 8
    lit[144:256] = 9
    lit[256:280] = 7
    lit[280:288] = 8
    dist = np.full(30, 5, np.int32)
    return _canon_tables(lit, 288), _canon_tables(dist, 30)


def _parse_header(inf: RawInflater, cur: _Cursor):
    """Parse one block header at cur.pos with the serial parser. Returns
    ('stored', start_byte, length) | ('huff', lit_tabs, dist_tabs,
    (wl, wd), sym_start_bit), *_tabs being _canon_tables packings. Raises
    InflateError exactly as inflate does."""
    inf.bitpos = cur.pos
    inf.state = _S_BLOCK_HEADER
    inf._last_lengths = None
    r = inf._read_block_header(finish=True)
    if r is NEED_INPUT:
        raise InflateError("unexpected end of stream")
    cur.final = inf.final_block
    if inf.state == _S_STORED:
        start_byte = inf.bitpos >> 3
        length = inf.stored_remaining
        if start_byte + length > len(inf.data):
            raise InflateError("unexpected end of stream")
        cur.pos = inf.bitpos + 8 * length
        return ("stored", start_byte, length)
    assert inf.state == _S_HUFF
    if inf._last_lengths is None:          # fixed (btype 1) block
        (lt, wl), (dt, wd) = _fixed_canon()
        return ("huff", lt, dt, (wl, wd), inf.bitpos)
    lengths, hlit, hdist = inf._last_lengths
    lt, wl = _canon_tables(lengths[:hlit], hlit)
    dt, wd = _canon_tables(lengths[hlit:hlit + hdist], hdist)
    return ("huff", lt, dt, (wl, wd), inf.bitpos)


def _advance_host(inf: RawInflater, cur: _Cursor):
    """Advance through stored blocks and headers until a Huffman block
    needs the device (returns its header tuple) or the segment is done
    (returns None)."""
    while not cur.done:
        if cur.end_bit is not None and cur.pos >= cur.end_bit:
            cur.done = True
            break
        hdr = _parse_header(inf, cur)
        if hdr[0] == "stored":
            _, start_byte, length = hdr
            if length:
                cur.toks.append((np.int32([B_STORED]), np.int32([start_byte]),
                                 np.int32([length])))
                cur.total_out += length
            if cur.final:
                cur.done = True
            continue
        return hdr
    return None


def _accept_tokens(cur: _Cursor, kind_row, aux_row, ntok, spec_idx,
                   spec_kind, spec_end, t_cap: int,
                   base_bit: int, real_bits: int) -> bool:
    """Interpret one lane's phase A output (kind and packed aux rows,
    fetched up to the wave's longest consumed prefix; the first special
    token's index, kind and end as scalars). Returns True if the block was
    decoded (cursor advanced), False to retry with a bigger lane."""
    n = int(ntok)
    if n >= t_cap:
        return False                     # token-array saturation: go bigger
    s = int(spec_idx)
    if s >= n:                           # no EOB/invalid among real tokens
        if real_bits < 4 * t_cap:        # lane already covers stream end
            raise _Fallback("no end-of-block before the stream's end")
        return False                     # block larger than lane: go bigger
    if spec_kind == K_INVALID:           # exact error via serial re-run
        raise _Fallback("invalid code")
    eob_end = int(spec_end)
    if eob_end > real_bits:              # truncated
        raise _Fallback("end-of-block past the stream's end")
    if s:
        k = kind_row[:s].astype(np.int32)
        packed = aux_row[:s].astype(np.int64) & 0xFFFFFFFF
        is_lit = k == K_LIT
        aux = np.where(is_lit, packed, packed & 0xFFFF).astype(np.int32)
        olen = np.where(is_lit, 1, packed >> 16).astype(np.int32)
        cur.toks.append((k, aux, olen))
        cur.total_out += int(olen.sum())
    cur.pos = base_bit + eob_end
    if cur.final:
        cur.done = True
    return True


def _upload(dev: torch.device, *arrays):
    return [upload(a, dev) for a in arrays]


def _phase_a_default(comp_j, byte_starts, lits, dists, start_bits,
                     lit_masks, dist_masks, cb, lit_cap, dist_cap):
    """Single-device phase A dispatch. Fetches the per-lane scalars first
    (one transfer), then one fetch of the kind/aux prefixes actually
    consumed (the (B, T_CAP) caps are ~5x the typical token count)."""
    tk, ta, nt, si, sk, se = _phase_a(
        comp_j, *_upload(comp_j.device, byte_starts, lits, dists, start_bits,
                         lit_masks, dist_masks), cb, lit_cap, dist_cap)
    nt_n, si_n, sk_n, se_n = fetch(torch.stack([nt, si, sk, se]))
    used = np.where((si_n < nt_n) & (sk_n == K_EOB), si_n, 0)
    mx = int(used.max()) if used.size else 0
    if mx > 0:
        tk_n = fetch(tk[:, :mx])
        ta_n = fetch(ta[:, :mx])
    else:
        B = nt_n.shape[0]
        tk_n = np.zeros((B, 0), np.int8)
        ta_n = np.zeros((B, 0), np.int32)
    return tk_n, ta_n, nt_n, si_n, sk_n, se_n


def _decode_segments(comp: bytes, seg_bounds, dictionary: bytes | None,
                     wsize: int, phase_a_fn=None, phase_b_fn=None,
                     device="cuda"):
    """Decode independent raw-deflate segments of `comp` on `device`.
    seg_bounds is a list of (start_bit, end_bit | None); a segment ends at
    its final block or at end_bit (a full-flush boundary; such segments
    have no final block). The dictionary applies to the first segment only
    (a full flush resets history). Returns (outputs, end_bits).

    phase_a_fn/phase_b_fn inject other device dispatches (a sharded step);
    None is one device. phase_b_fn receives batched (S, T) token arrays
    padded to one (t_cap, out_cap) and returns (outs (S, out_cap - _DPAD)
    numpy, bad (S,))."""
    try:
        with _trace.call("decode", _publish):
            return _decode_waves(comp, seg_bounds, dictionary, wsize,
                                 phase_a_fn or _phase_a_default,
                                 phase_b_fn or _phase_b_default,
                                 torch.device(device))
    except (_Fallback, InflateError) as e:
        decode_stats["fallback_cause"] = str(e)
        raise


def _decode_waves(comp, seg_bounds, dictionary, wsize, phase_a_fn,
                  phase_b_fn, dev):
    """_decode_segments' body: the phase A waves, then phase B."""
    comp_np = np.frombuffer(comp, np.uint8)
    parser = RawInflater()
    parser.feed(comp)
    cursors = [_Cursor(s, e) for s, e in seg_bounds]
    max_bucket = len(_CB_BUCKETS) - 1
    # a block never outlives its segment, so each cursor starts at the
    # bucket that covers the segment's compressed size
    for cur in cursors:
        seg_bytes = (((cur.end_bit if cur.end_bit is not None
                       else 8 * len(comp)) - cur.pos) + 7) // 8
        while cur.bucket < max_bucket \
                and _CB_BUCKETS[cur.bucket] < seg_bytes:
            cur.bucket += 1

    # the compressed stream goes up once, shared by every phase A wave
    # (lanes are sliced on the device) and by phase B's stored runs
    comp_cap = max(2048, 1 << (len(comp) - 1).bit_length()) if comp else 2048
    comp_pad = np.zeros(comp_cap, np.uint8)
    comp_pad[:len(comp)] = comp_np
    comp_j = upload(comp_pad, dev)

    for wave in itertools.count():
        # host: headers and stored blocks; collect lanes needing the device
        pend = []
        for cur in cursors:
            if cur.done:
                continue
            hdr = _advance_host(parser, cur)
            if hdr is not None:
                pend.append((cur, hdr))
        if not pend:
            break
        count("waves")

        # batch by bucket size
        by_bucket = {}
        for cur, hdr in pend:
            by_bucket.setdefault(cur.bucket, []).append((cur, hdr))
        for bucket, group in by_bucket.items():
            cb = min(_CB_BUCKETS[bucket], comp_cap)
            B = len(group)
            Bpad = 1 << (B - 1).bit_length()
            # device LUT build size: the wave's widest table (pow2 bucket)
            lit_cap = dist_cap = 512
            for _, (_, _lt, _dt, (wl, wd), _) in group:
                lit_cap = max(lit_cap, 1 << wl)
                dist_cap = max(dist_cap, 1 << wd)
            lits = np.zeros((Bpad, 48 + 288), np.int32)
            dists = np.zeros((Bpad, 48 + 30), np.int32)
            byte_starts = np.zeros(Bpad, np.int32)
            start_bits = np.zeros(Bpad, np.int32)
            # mask 0 for padding lanes (reads only entry 0)
            lit_masks = np.zeros(Bpad, np.int32)
            dist_masks = np.zeros(Bpad, np.int32)
            meta = []
            for i, (cur, (_, lit, dist, (wl, wd), sym_bit)) in enumerate(group):
                base_byte = min(sym_bit >> 3, comp_cap - cb)
                lits[i, :lit.size] = lit
                dists[i, :dist.size] = dist
                lit_masks[i] = (1 << wl) - 1
                dist_masks[i] = (1 << wd) - 1
                byte_starts[i] = base_byte
                start_bits[i] = sym_bit - 8 * base_byte
                real = 8 * (min(len(comp) - base_byte, cb))
                meta.append((cur, 8 * base_byte, real))
            with span("phase_a", wave=wave, cb=cb):
                tk, ta, nt, si_, sk, se = phase_a_fn(
                    comp_j, byte_starts, lits, dists, start_bits,
                    lit_masks, dist_masks, cb, lit_cap, dist_cap)
            count("phase_a")
            count("phase_a_lanes", B)
            retries = 0
            for i, (cur, base_bit, real_bits) in enumerate(meta):
                ok = _accept_tokens(cur, tk[i], ta[i], nt[i], si_[i], sk[i],
                                    se[i], 2 * cb, base_bit, real_bits)
                if not ok:
                    if cur.bucket >= max_bucket \
                            or _CB_BUCKETS[cur.bucket] >= comp_cap:
                        raise _Fallback("block larger than the largest lane")
                    cur.bucket += 1
                    retries += 1
            count("phase_a_retries", retries)

    # phase B
    dict_bytes = (dictionary or b"")[-32768:]
    dictv = np.zeros(1 << 15, np.uint8)
    if dict_bytes:
        dictv[-len(dict_bytes):] = np.frombuffer(dict_bytes, np.uint8)
    dictv_j = upload(dictv, dev)

    return _phase_b_batched(cursors, dict_bytes, comp_j, dictv_j, wsize,
                            phase_b_fn)


def _phase_b_default(kinds, auxs, olens, comp_j, dictv_j, dict_lens, wsize,
                     out_cap):
    """Single-device batched phase B: one dispatch for all segments, one
    fetch of the output past the window pad."""
    k, a, o, dl = _upload(comp_j.device, kinds, auxs, olens, dict_lens)
    out, bad = _phase_b_multi(k, a, o, comp_j, dictv_j, dl, int(wsize),
                              out_cap)
    return fetch(out[:, _DPAD:]), fetch(bad)


def _phase_b_batched(cursors, dict_bytes, comp_j, dictv_j, wsize,
                     phase_b_fn):
    """Batched phase B: all segments padded to one (t_cap, out_cap) and
    rebuilt in a single dispatch."""
    live = [(si, cur) for si, cur in enumerate(cursors) if cur.toks]
    outputs = [b""] * len(cursors)
    end_bits = [cur.pos for cur in cursors]
    if live:
        t_cap = max(1 << 10, 1 << max(
            (sum(len(t[0]) for t in cur.toks) - 1).bit_length()
            for _, cur in live))
        out_cap = 1 << int(np.ceil(np.log2(
            _DPAD + max(cur.total_out for _, cur in live) + 1)))
        S = len(live)
        kinds = np.zeros((S, t_cap), np.int32)
        auxs = np.zeros((S, t_cap), np.int32)
        olens = np.zeros((S, t_cap), np.int32)
        dlens = np.zeros(S, np.int32)
        for j, (si, cur) in enumerate(live):
            kind = np.concatenate([t[0] for t in cur.toks])
            kinds[j, :len(kind)] = kind
            auxs[j, :len(kind)] = np.concatenate([t[1] for t in cur.toks])
            olens[j, :len(kind)] = np.concatenate([t[2] for t in cur.toks])
            dlens[j] = len(dict_bytes) if si == 0 else 0
        with span("phase_b"):
            outs, bads = phase_b_fn(kinds, auxs, olens, comp_j, dictv_j,
                                    dlens, wsize, out_cap)
        count("phase_b")
        if bool(np.asarray(bads).any()):
            raise _Fallback("distance before the window or dictionary")
        # contract: outs rows are numpy, starting at the data (the _DPAD
        # window-pad region is cut off on the device before the fetch)
        for j, (si, cur) in enumerate(live):
            outputs[si] = outs[j][:cur.total_out].tobytes()
    return outputs, end_bits


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def inflate_raw_cuda(data: bytes, wbits: int = 15,
                     dictionary: bytes | None = None, engine: str = "auto",
                     start: int = 0, device="cuda"):
    """One-shot raw inflate of data[start:] on `device` (the card unless
    device="cpu"). Returns (out, bits consumed past start).

    engine: "auto" routes unindexed streams over _DEVICE_SINGLE_MAX bytes
    to the host decoder and keeps smaller ones on the device batch path;
    "device"/"host" force a path. Any anomaly reruns the stream on the
    serial decoder, so errors and messages are zlib's."""
    dev = _device(device, "inflate_raw_cuda")
    data = bytes(data)
    if engine == "host" or (engine == "auto"
                            and len(data) - start > _DEVICE_SINGLE_MAX):
        stats["host_routed"] += 1
        trace("inflate route=host engine=%s comp_bytes=%d", engine,
              len(data) - start)
        return _serial.inflate_raw(data, wbits=wbits, dictionary=dictionary,
                                   start=start)
    if start:
        data = data[start:]
    try:
        outs, ends = _decode_segments(data, [(0, None)], dictionary,
                                      1 << wbits, device=dev)
        stats["device_ok"] += 1
        trace("inflate route=device comp_bytes=%d out_bytes=%d", len(data),
              len(outs[0]))
        return outs[0], ends[0]
    except (_Fallback, InflateError):
        stats["fallback"] += 1
        trace("inflate route=fallback comp_bytes=%d", len(data))
        return _serial.inflate_raw(data, wbits=wbits, dictionary=dictionary)


def decompress_cuda(data: bytes, wbits: int = 15,
                    dictionary: bytes | None = None, engine: str = "auto",
                    device="cuda") -> bytes:
    """zlib.decompress-compatible one-shot on `device` (the card unless
    device="cpu"): zlib/gzip/raw/auto framing, the DEFLATE payload through
    the engine `engine` picks (see inflate_raw_cuda), trailers checked on
    the host."""
    from ..format.headers import NeedMoreInput
    dev = _device(device, "decompress_cuda")
    try:
        return _decompress_cuda(data, wbits=wbits, dictionary=dictionary,
                                engine=engine, device=dev)
    except NeedMoreInput:  # truncated header on the one-shot surface
        raise InflateError("unexpected end of stream") from None


def _decompress_cuda(data: bytes, wbits: int, dictionary: bytes | None,
                     engine: str, device) -> bytes:
    import struct

    from ..checksum.adler32 import adler32
    from ..checksum.crc32 import crc32
    from ..format import headers as H
    from ..format.constants import GZIP_MAGIC

    data = bytes(data)
    if wbits < 0:
        out, _ = inflate_raw_cuda(data, wbits=-wbits, dictionary=dictionary,
                                  engine=engine, device=device)
        return out

    if wbits >= 32:
        wbits = (wbits & 15) + (16 if data[:2] == GZIP_MAGIC else 0)

    if wbits >= 16:
        _, pos = H.parse_gzip_header(data)
        out, bits = inflate_raw_cuda(data, wbits=(wbits - 16) or 15,
                                     engine=engine, start=pos, device=device)
        pos += (bits + 7) // 8
        if len(data) < pos + 8:
            raise InflateError("unexpected end of stream")
        expect_crc, expect_isize = struct.unpack("<II", data[pos:pos + 8])
        if crc32(out) != expect_crc:
            raise InflateError("incorrect data check")
        if expect_isize != (len(out) & 0xFFFFFFFF):
            raise InflateError("incorrect length check")
        return out

    hwbits, has_dict, dictid, pos = H.parse_zlib_header(data)
    if has_dict:
        if dictionary is None:
            raise InflateError("preset dictionary needed")
        if adler32(dictionary) != dictid:
            raise InflateError("incorrect dictionary")
    out, bits = inflate_raw_cuda(data, wbits=max(hwbits, 8),
                                 dictionary=dictionary if has_dict else None,
                                 engine=engine, start=pos, device=device)
    pos += (bits + 7) // 8
    if len(data) < pos + 4:
        raise InflateError("unexpected end of stream")
    if adler32(out) != struct.unpack(">I", data[pos:pos + 4])[0]:
        raise InflateError("incorrect data check")
    return out


def decompress_segments_cuda(blob: bytes, start_bytes,
                             device="cuda") -> list[bytes]:
    """Decode independent full-flush segments of a raw stream in one
    batched device pass on `device` (the card unless device="cpu"):
    segments advance in lockstep waves, each wave one phase A dispatch per
    lane bucket over all segments' current blocks. start_bytes[i] ..
    start_bytes[i+1] (or the stream's end) bounds segment i; non-final
    segments end at the full-flush marker, not a final block."""
    dev = _device(device, "decompress_segments_cuda")
    blob = bytes(blob)
    starts = list(start_bytes)
    bounds = []
    for i, s in enumerate(starts):
        end = 8 * starts[i + 1] if i + 1 < len(starts) else None
        bounds.append((8 * s, end))
    try:
        outs, _ = _decode_segments(blob, bounds, None, 1 << 15, device=dev)
        stats["device_ok"] += 1
        return outs
    except (_Fallback, InflateError):
        stats["fallback"] += 1
        outs = []
        ends = starts[1:] + [len(blob)]
        for i in range(len(starts)):
            inf = RawInflater()
            inf.feed(blob[starts[i]:ends[i]])
            inf.run(finish=(i == len(starts) - 1))
            outs.append(inf.output())
        return outs
