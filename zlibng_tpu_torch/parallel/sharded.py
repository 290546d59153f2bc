"""Sharded compression and decode over several devices.

Counterpart of `zlibng_tpu/parallel/sharded.py`. The reference's `Mesh`
becomes a `Shards`: one torch.device per shard this process holds, and
optionally a torch.distributed process group whose ranks each hold the same
number of shards. The shard count (every rank's shards together) decides
the bytes, as the mesh size does in the reference; where a shard runs does
not. A device may repeat (`[cuda:0] * 8` runs eight shards on one card).

  * lanes (lane_block payload + 32 KiB history) split across the shards;
    each shard runs the whole pipeline on its lanes: LZ77 (K1 through
    `lz77_lane`), the parse walk (K2 through `parse_select_encode`),
    Huffman render and bit pack, with per-lane dynamic, static or stored
    blocks chosen on the host from per-lane histograms;
  * `shard_map` becomes a loop of per-shard steps, each on its shard's
    device, and each in-graph `all_gather` becomes `Shards.gather`: a
    concatenation in one process, `torch.distributed.all_gather` over a
    process group (the reference's to_dev/to_host seam is `Shards.put` and
    `Shards.gather`);
  * adler32 partials merge with the exact closed-form combine;
  * decode runs phase A lanes and phase B segments across the shards
    through the wave engine's seams (`ops/inflate.py:_decode_segments`).

On a card every shard reaches K1, K2, the render (`render_rows`, one
launch of `csrc/render.cu` per shard and step) and the pack (`pack_rows`,
one launch of `csrc/bitpack.cu` per shard and step) through their wrappers,
which launch the CUDA kernels for CUDA tensors; CPU shards run the plain
versions.

`compress_multichip` opens a trace root (`trace.py`) whose spans and
counters fill `ops/deflate.py:stage_seconds`: `frame` (host: the flat
chunks and their upload; the adler32 combine, header and trailer),
`sharded.stage1` and `sharded.stage2` (host: from the first shard's enqueue
to the gathered results), each with one `sharded.stage1.shard` or
`sharded.stage2.shard` span per shard on that shard's device (`shard=s`),
`sharded.trees` (host: the cost prepass, the per-lane trees and the
stored/static/dynamic choice) and `stitch` (host: the packed gather and
the bit stitch); the counters `sharded.shards`, `sharded.lanes` and
`sharded.lanes_stored`, `_static`, `_dynamic` (which sum to the lanes).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..checksum.adler32 import adler32_combine
from ..errors import DataError as InflateError
from ..format import headers as H
from ..format.constants import (
    ADLER_BASE, FIXED_DIST_CODES_REV, FIXED_DIST_LENGTHS,
    FIXED_LIT_CODES_REV, FIXED_LIT_LENGTHS, MAX_BITS, WINDOW_SIZE,
)
from ..huffman.encode import build_dynamic_header, huffman_table
from ..ops import deflate as _deflate
from ..ops import inflate as IT
from ..ops.bitpack import code_tables, render_rows
from ..ops.bitpack_merge import pack_rows
from ..ops.deflate import (
    HMAX, _BitStitcher, _device, _est_block_bits_batch, _extra_bits_batch,
    _header_tokens_to_arrays, _lane_slices,
)
from ..ops.lz77 import finalize_tokens, lane_freqs, lz77_lane
from ..ops.parse import parse_select_encode
from ..stream.deflate import LEVELS
from ..trace import call, count, fetch, span, upload

I32 = torch.int32
I64 = torch.int64


class Shards:
    """The shards of a sharded call: `devices` holds one device per shard
    of this process; with `group`, every rank of that torch.distributed
    group holds as many, and rank r's shards come after those of ranks
    below r. `put` and `gather` are the placement seam."""

    def __init__(self, devices, group=None):
        self.devices = [_device(d, "sharded path") for d in devices]
        if not self.devices:
            raise ValueError("sharded path: no devices")
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        self.count = len(self.devices) * self.world
        self.first = self.rank * len(self.devices)

    def local(self):
        """(global shard index, device) of each shard of this process."""
        return [(self.first + i, d) for i, d in enumerate(self.devices)]

    def put(self, arr: np.ndarray) -> list[torch.Tensor]:
        """Split a host array on axis 0 into count equal parts and place
        this process's parts on their shards' devices."""
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        per = arr.shape[0] // self.count
        return [upload(arr[g * per:(g + 1) * per], d)
                for g, d in self.local()]

    def gather(self, parts: list[torch.Tensor]) -> np.ndarray:
        """Every shard's part (this process's `parts`, equal shapes),
        concatenated on axis 0 in shard order, as a host array on every
        process: the reference's all_gather."""
        if self.group is None:
            return np.concatenate([fetch(p) for p in parts])
        import torch.distributed as dist
        nccl = dist.get_backend(self.group) == "nccl"
        comm = self.devices[0] if nccl else torch.device("cpu")
        x = torch.cat([p.to(comm) for p in parts])
        outs = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(outs, x, group=self.group)
        return fetch(torch.cat(outs))


def visible_shards(devices=None, group=None) -> Shards:
    """`devices` as Shards; None means every visible card (one process),
    or, over a process group, the rank's own card under NCCL and the CPU
    under gloo. Without a card a CUDA request raises."""
    if devices is None:
        if group is not None:
            import torch.distributed as dist
            if dist.get_backend(group) != "nccl":
                devices = ["cpu"]
            else:
                n = torch.cuda.device_count()
                devices = [f"cuda:{dist.get_rank(group) % max(n, 1)}"]
        elif torch.cuda.is_available():
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        else:
            devices = ["cuda"]                   # raises in _device
    return Shards(devices, group)


# ---------------------------------------------------------------------------
# adler32 on the shards
# ---------------------------------------------------------------------------
def _adler_combine_pair(a: torch.Tensor, b: torch.Tensor, len2: torch.Tensor):
    """adler32_combine in closed form (int64 holding the reference's exact
    uint32 mod arithmetic)."""
    base = ADLER_BASE
    rem = len2.to(I64) % base
    s1a, s2a = a & 0xFFFF, (a >> 16) & 0xFFFF
    s1b, s2b = b & 0xFFFF, (b >> 16) & 0xFFFF
    s1 = (s1a + s1b + base - 1) % base
    s2 = (s2a + s2b + (rem * s1a) % base + base - rem) % base
    return (s2 << 16) | s1


def _mod_tree(x: torch.Tensor, base: int) -> torch.Tensor:
    """Pairwise mod-base tree sum over the last axis of values < base."""
    while x.shape[-1] > 1:
        half = (x.shape[-1] + 1) // 2
        x = F.pad(x, (0, 2 * half - x.shape[-1]))
        x = (x[..., :half] + x[..., half:]) % base
    return x[..., 0]


def _lane_adler(lanes: torch.Tensor, enc_starts: torch.Tensor,
                enc_ends: torch.Tensor) -> torch.Tensor:
    """Adler32 of each (B, N) lane's payload slice [enc_start, enc_end):
    per 2048-byte chunk, a chunk-local weighted sum plus the chunk sum times
    the bytes after the chunk, both reduced mod base first, as the
    reference's uint32 form keeps every product below 2^32. Returns (B,)
    int64."""
    B, N = lanes.shape
    CH = 2048
    Np = -(-N // CH) * CH
    base = ADLER_BASE
    dev = lanes.device
    es = enc_starts.to(I64)[:, None]
    ee = enc_ends.to(I64)[:, None]
    pos = torch.arange(N, dtype=I64, device=dev)
    b = torch.where((pos >= es) & (pos < ee), lanes.to(I64), 0)
    bs = F.pad(b, (0, Np - N)).reshape(B, -1, CH)
    csum = bs.sum(2) % base
    wloc = CH - torch.arange(CH, dtype=I64, device=dev)
    wsum = (bs * wloc).sum(2) % base
    chunk_end = (torch.arange(Np // CH, dtype=I64, device=dev) + 1) * CH
    trailing = (ee - chunk_end) % base
    t = (wsum + (csum * trailing) % base) % base
    s1 = (1 + _mod_tree(csum, base)) % base
    s2 = (_mod_tree(t, base) + (ee[:, 0] - es[:, 0]) % base) % base
    return (s2 << 16) | s1


def _fold_adlers(adlers: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """One shard's lane checksums combined in lane order, as (1,) int64."""
    acc = torch.ones((), dtype=I64, device=adlers.device)
    for i in range(adlers.shape[0]):
        acc = _adler_combine_pair(acc, adlers[i], lens[i])
    return acc[None]


def combine_shard_adlers(adlers: np.ndarray, shard_payload_lens) -> int:
    """Host-side exact merge of per-shard adler values (ordered)."""
    acc = 1
    for a, ln in zip(np.asarray(adlers).tolist(), shard_payload_lens):
        acc = adler32_combine(acc, int(a), int(ln))
    return acc


def _one_enc_start(enc_starts: np.ndarray) -> int:
    """The lanes' common enc_start: `lz77_lane` takes one per call."""
    vals = np.unique(np.asarray(enc_starts))
    if vals.size != 1:
        raise ValueError("sharded step: every lane needs the same enc_start")
    return int(vals[0])


def _emit_packed(lanes, lo, hi, nb, hdr_lo, hdr_hi, hdr_nb, lit_lens,
                 lit_codes, enc_starts, enc_ends, out_max):
    """Header tokens + body tokens + EOB of each lane packed into one
    block, and the shard's combined payload adler32."""
    eob_lo = lit_codes[:, 256:257].to(I64)
    eob_nb = lit_lens[:, 256:257].to(I32)
    lo_all = torch.cat([hdr_lo.to(I64), lo, eob_lo], 1)
    hi_all = torch.cat([hdr_hi.to(I64), hi, torch.zeros_like(eob_lo)], 1)
    nb_all = torch.cat([hdr_nb.to(I32), nb, eob_nb], 1)
    packed, total = pack_rows(lo_all, hi_all, nb_all, out_max)
    adlers = _lane_adler(lanes, enc_starts, enc_ends)
    return packed, total, _fold_adlers(adlers, enc_ends - enc_starts)


def make_compress_step(shards: Shards, lane_size: int, out_max: int,
                       chain: int = 4, lazy: bool = True,
                       max_lazy: int = 16):
    """A sharded static-tree compression step over `shards`.

    step(lanes (B, lane_size) u8, enc_starts, enc_ends, hist_valids (B,)
    int32, host arrays; B divisible by the shard count) ->
      packed [(B/count, out_max) u8 per local shard], total_bits [(B/count,)
      int32 per local shard], all_bits (B,) int32 (every shard's, gathered),
      adler (count,) int64 per-shard payload checksums (combinable).
    """
    def shard_fn(lanes, es, enc_starts, enc_ends, hist_valids):
        B, N = lanes.shape
        dev = lanes.device
        core = lz77_lane(lanes, es, enc_ends, hist_valids, chain, lazy,
                         max_lazy)
        bounds = torch.stack([enc_starts, enc_ends], 1).to(I32).contiguous()
        sel = parse_select_encode(core["step"], bounds)
        outs = finalize_tokens(lanes, core, sel)
        C = code_tables(dev)
        lo, hi, nb = render_rows(lanes, outs["tok_len"], outs["tok_dist"],
                                 outs["sel"], C["fl288"], C["flc"],
                                 C["fdl"], C["fdc"])
        # static block header (BFINAL=0 within shards) + EOB
        hdr_lo = torch.full((B, 1), 2, dtype=I64, device=dev)
        hdr_nb = torch.full((B, 1), 3, dtype=I32, device=dev)
        return _emit_packed(lanes, lo, hi, nb, hdr_lo,
                            torch.zeros_like(hdr_lo), hdr_nb,
                            C["fl288"].expand(B, -1), C["flc"].expand(B, -1),
                            enc_starts, enc_ends, out_max)

    def step(lanes, enc_starts, enc_ends, hist_valids):
        es = _one_enc_start(enc_starts)
        res = [shard_fn(ln, es, *a) for ln, *a in zip(*(
            shards.put(x) for x in (lanes, enc_starts, enc_ends,
                                    hist_valids)))]
        packed, totals, adlers = (list(r) for r in zip(*res))
        return packed, totals, shards.gather(totals), shards.gather(adlers)

    return step


# ---------------------------------------------------------------------------
# dynamic-Huffman sharded pipeline (two sharded steps + host tree build)
# ---------------------------------------------------------------------------
def make_stage1_step(shards: Shards, lane_block: int, hist: int,
                     chain: int = 4, lazy: bool = True, max_lazy: int = 16,
                     nice: int = 258, good: int = 12):
    """Sharded stage 1: LZ77 parse + per-lane symbol histograms.

    step(flat [(1, hist + lps*lane_block) u8 per local shard], enc_starts,
    enc_ends, hist_valids (B,) int32 host arrays) -> (sel, tok_len,
    tok_dist [(lps, L) per local shard], lfreq (B, 286), dfreq (B, 30)
    gathered). Lanes are sliced from each shard's flat chunk on its device
    (the 32 KiB history is duplicated once per shard, not per lane)."""
    lane_sz = hist + lane_block

    def shard_fn(flat, es, enc_starts, enc_ends, hist_valids):
        lps = enc_starts.shape[0]
        lanes = _lane_slices(flat[0], 0, lane_block, lane_sz, lps)
        core = lz77_lane(lanes, es, enc_ends, hist_valids, chain, lazy,
                         max_lazy, nice, good=good)
        bounds = torch.stack([enc_starts, enc_ends], 1).to(I32).contiguous()
        sel = parse_select_encode(core["step"], bounds)
        outs = finalize_tokens(lanes, core, sel)
        lfreq, dfreq = lane_freqs(outs["lsym"], outs["dsym"], outs["sel"],
                                  outs["tok_len"] > 0)
        return outs["sel"], outs["tok_len"], outs["tok_dist"], lfreq, dfreq

    def step(flat, enc_starts, enc_ends, hist_valids):
        es = _one_enc_start(enc_starts)
        res = []
        for (g, dev), f, *a in zip(shards.local(), flat, *(
                shards.put(x) for x in (enc_starts, enc_ends, hist_valids))):
            with span("sharded.stage1.shard", dev, shard=g):
                res.append(shard_fn(f, es, *a))
        sel, tok_len, tok_dist, lfreq, dfreq = (list(r) for r in zip(*res))
        return (sel, tok_len, tok_dist, shards.gather(lfreq),
                shards.gather(dfreq))

    return step


def make_stage2_step(shards: Shards, out_max: int, lane_block: int,
                     hist: int):
    """Sharded stage 2: render + pack each lane as one DEFLATE block
    against its own (host-built, dynamic or static) code tables, plus the
    gathered lengths and per-shard adler32s.

    step(flat, tok_len, tok_dist, sel [per local shard], hdr_lo/hi/nb
    (B, HMAX), llen/lcode (B, 288), dlen/dcode (B, 30), enc_starts,
    enc_ends (B,) host arrays) -> (packed [(lps, out_max) u8 per local
    shard], total_bits [per local shard], all_bits (B,) gathered,
    shard_adlers (count,) gathered)."""
    lane_sz = hist + lane_block

    def shard_fn(flat, tl, td, se, hlo, hhi, hnb, lt, lc, dt, dc, es, ee):
        lanes = _lane_slices(flat[0], 0, lane_block, lane_sz, es.shape[0])
        lo, hi, nb = render_rows(lanes, tl, td, se, lt, lc, dt, dc)
        return _emit_packed(lanes, lo, hi, nb, hlo, hhi, hnb, lt, lc, es, ee,
                            out_max)

    def step(flat, tok_len, tok_dist, sel, *host):
        res = []
        for (g, dev), *a in zip(shards.local(), flat, tok_len, tok_dist, sel,
                                *(shards.put(x) for x in host)):
            with span("sharded.stage2.shard", dev, shard=g):
                res.append(shard_fn(*a))
        packed, totals, adlers = (list(r) for r in zip(*res))
        return packed, totals, shards.gather(totals), shards.gather(adlers)

    return step


def compress_multichip(data: bytes, devices=None, level: int = 6,
                       lane_block: int = 1 << 16, group=None) -> bytes:
    """Sharded zlib compression: lanes split across the shards, each lane
    becomes one DEFLATE block with its own dynamic or static tree (built on
    the host from the shards' histograms) or stored blocks, and the host
    stitches the blocks and wraps them with the combined adler32. Output
    is one standard zlib stream, byte-identical to the reference's
    `compress_multichip` on a mesh of as many devices as there are shards.
    The call's spans and counters fill `ops/deflate.py:stage_seconds`.

    devices: this process's shard devices (None: every visible card; pass
    ["cpu"] * k for k shards on the CPU). group: a torch.distributed
    process group whose ranks each run this call on their own shards."""
    shards = visible_shards(devices, group)
    with call("compress_multichip", _deflate._publish):
        return _compress_multichip(data, shards, level, lane_block)


def _compress_multichip(data, shards: Shards, level: int,
                        lane_block: int) -> bytes:
    """compress_multichip's body, inside its trace root."""
    ndev = shards.count
    count("sharded.shards", ndev)
    with span("frame"):
        lc = LEVELS[max(1, min(9, level))]
        buf = np.frombuffer(memoryview(bytes(data)), np.uint8)
        n = buf.size
        hist = WINDOW_SIZE
        nblocks = max(1, -(-n // lane_block))
        B = -(-nblocks // ndev) * ndev            # pad lane count to shards
        lps = B // ndev                           # lanes per shard
        vbuf = np.concatenate([np.zeros(hist, np.uint8), buf,
                               np.zeros(B * lane_block - n, np.uint8)])
        # per-shard flat chunks: the 32 K history once per shard
        flat_len = hist + lps * lane_block
        flat_sh = np.zeros((ndev, flat_len), np.uint8)
        for s in range(ndev):
            base = s * lps * lane_block
            flat_sh[s] = vbuf[base: base + flat_len]
        enc_starts = np.full(B, hist, np.int32)
        enc_ends = np.full(B, hist, np.int32)
        hist_valids = np.full(B, hist, np.int32)  # empty pad lanes: none
        for bi in range(nblocks):
            enc_ends[bi] = hist + min(lane_block, n - bi * lane_block)
            hist_valids[bi] = hist if bi == 0 else 0
        out_max = lane_block + (lane_block >> 2) + 1024
        flat_d = shards.put(flat_sh)

    s1 = make_stage1_step(shards, lane_block, hist, lc.chain, lc.lazy,
                          lc.max_lazy, lc.nice, good=lc.good)
    s2 = make_stage2_step(shards, out_max, lane_block, hist)
    with span("sharded.stage1"):
        sel, tok_len, tok_dist, lfreqs, dfreqs = s1(flat_d, enc_starts,
                                                     enc_ends, hist_valids)
    lfreqs = lfreqs.astype(np.int64)
    dfreqs = dfreqs.astype(np.int64)
    plens = (enc_ends - enc_starts).astype(np.int64)          # payload bytes

    with span("sharded.trees"):
        # host: vectorized cost prepass + per-lane tree build + three-way
        # stored/static/dynamic choice (trees.c:657-692): an incompressible
        # lane is emitted as raw stored blocks
        lfreqs[:, 256] += 1                                   # EOB per lane
        extra_v = _extra_bits_batch(lfreqs, dfreqs)           # (B,)
        static_v = lfreqs @ FIXED_LIT_LENGTHS[:286].astype(np.int64) \
            + dfreqs @ FIXED_DIST_LENGTHS.astype(np.int64) + extra_v  # (B,)
        # exact stored cost: per 65535-byte chunk 3-bit header + pad(<=7) + 32
        nchunks = np.maximum(1, -(-plens // 0xFFFF))
        stored_v = 8 * plens + nchunks * (32 + 3 + 7)
        ests = _est_block_bits_batch(lfreqs, dfreqs, extra_v)  # (B,) float
        # prestored: stored so clearly wins that the tree build is skipped
        prestored = stored_v + 64 < np.minimum(ests, static_v)

        hdr_lo = np.zeros((B, HMAX), np.uint32)
        hdr_hi = np.zeros((B, HMAX), np.uint32)
        hdr_nb = np.zeros((B, HMAX), np.int32)
        llen_tab = np.zeros((B, 288), np.int32)
        lcode_tab = np.zeros((B, 288), np.int32)
        dlen_tab = np.zeros((B, 30), np.int32)
        dcode_tab = np.zeros((B, 30), np.int32)
        stored_mask = np.zeros(B, bool)
        n_dynamic = 0
        for bi in range(nblocks):
            final = bi == nblocks - 1
            if prestored[bi]:
                stored_mask[bi] = True
                continue
            lfreq = lfreqs[bi]
            dfreq = dfreqs[bi]
            static_bits = int(static_v[bi])
            llen, lcode = huffman_table(lfreq, MAX_BITS)
            dlen, dcode = huffman_table(dfreq, MAX_BITS)
            toks, hbits = build_dynamic_header(llen, dlen)
            dyn_bits = int((lfreq * llen).sum() + (dfreq * dlen).sum()) \
                + int(extra_v[bi]) + hbits
            best = min(static_bits, dyn_bits)
            if int(stored_v[bi]) < best + 3:                  # exact re-choice
                stored_mask[bi] = True
                continue
            if dyn_bits < static_bits:
                n_dynamic += 1
                tokens = [(int(final) | (2 << 1), 3)] + toks
                llen_tab[bi, :286], lcode_tab[bi, :286] = llen, lcode
                dlen_tab[bi], dcode_tab[bi] = dlen, dcode
            else:
                tokens = [(int(final) | (1 << 1), 3)]
                llen_tab[bi] = FIXED_LIT_LENGTHS
                lcode_tab[bi] = FIXED_LIT_CODES_REV
                dlen_tab[bi, :] = FIXED_DIST_LENGTHS
                dcode_tab[bi, :] = FIXED_DIST_CODES_REV
            hdr_lo[bi], hdr_hi[bi], hdr_nb[bi] = \
                _header_tokens_to_arrays(tokens)
        n_stored = int(stored_mask.sum())
        count("sharded.lanes", nblocks)
        count("sharded.lanes_stored", n_stored)
        count("sharded.lanes_static", nblocks - n_stored - n_dynamic)
        count("sharded.lanes_dynamic", n_dynamic)

    with span("sharded.stage2"):
        packed, _, totals_np, shard_adlers = s2(
            flat_d, tok_len, tok_dist, sel, hdr_lo, hdr_hi, hdr_nb, llen_tab,
            lcode_tab, dlen_tab, dcode_tab, enc_starts, enc_ends)

    with span("stitch"):
        packed_np = shards.gather(packed)
        stitch = _BitStitcher()
        for bi in range(nblocks):
            if stored_mask[bi]:
                # raw stored blocks straight from the input (the lane's
                # packed output is ignored; its adler32 still counts)
                p0 = hist + bi * lane_block
                plen = int(plens[bi])
                pos = 0
                while True:
                    take = min(plen - pos, 0xFFFF)
                    last = (bi == nblocks - 1) and (pos + take == plen)
                    pad = (8 - ((stitch.bits + 3) & 7)) & 7
                    stitch.append_tokens([
                        (int(last), 1), (0, 2), (0, pad),
                        (take, 16), (~take & 0xFFFF, 16)])
                    stitch.append(vbuf[p0 + pos: p0 + pos + take], take * 8)
                    pos += take
                    if pos >= plen:
                        break
            else:
                stitch.append(packed_np[bi], int(totals_np[bi]))

    with span("frame"):
        shard_lens = [int(plens[s * lps:(s + 1) * lps].sum())
                      for s in range(ndev)]
        adler = combine_shard_adlers(shard_adlers, shard_lens)
        return (H.build_zlib_header(wbits=15, level=level)
                + stitch.getvalue() + H.build_zlib_trailer(adler))


# ---------------------------------------------------------------------------
# sharded batch decode (phase A/B over the shards)
# ---------------------------------------------------------------------------
def _replica(cache: dict, t: torch.Tensor, dev: torch.device):
    """`t` on `dev`, copied once per call (the cache keeps `t` alive, so
    its id stays unique)."""
    key = (id(t), str(dev))
    if key not in cache:
        cache[key] = (t, t.to(dev))
    return cache[key][1]


def make_decode_phase_a(shards: Shards, cb: int, lit_cap: int,
                        dist_cap: int):
    """Sharded phase A: speculative token resolution (`ops/inflate.py:
    _phase_a`, whose walk is K2 on a card) over lanes split across the
    shards; the compressed stream is replicated on every shard's device.
    step(comp (C,) u8 tensor, byte_starts, lit_tabs, dist_tabs, start_bits,
    lit_masks, dist_masks host arrays, lane count divisible by the shard
    count) -> _phase_a's six outputs for every lane, gathered."""
    replicas: dict = {}

    def step(comp, *host):
        res = [IT._phase_a(_replica(replicas, comp, dev), *a, cb, lit_cap,
                           dist_cap)
               for (_, dev), *a in zip(shards.local(),
                                       *(shards.put(x) for x in host))]
        return tuple(shards.gather(list(r)) for r in zip(*res))

    return step


def make_decode_phase_b(shards: Shards, out_cap: int):
    """Sharded phase B: LZ77 reconstruction of independent segments
    (pointer doubling + gather), segments split across the shards, the
    compressed stream and the dictionary replicated. Each shard runs the
    batched `_phase_b_multi` on its segments: a row's pointer doubling
    reaches the same fixpoint in any batch, so it equals the reference's
    per-segment `_phase_b`. step(kinds, auxs, olens (S, T), comp, dictv
    tensors, dict_lens (S,), wsize) -> (out (S, out_cap - _DPAD) u8, rows
    starting at the data, bad (S,) bool), gathered."""
    replicas: dict = {}

    def step(kinds, auxs, olens, comp, dictv, dict_lens, wsize):
        outs, bads = [], []
        for (_, dev), k, a, o, dl in zip(
                shards.local(), *(shards.put(x) for x in (kinds, auxs, olens,
                                                          dict_lens))):
            out, bad = IT._phase_b_multi(
                k, a, o, _replica(replicas, comp, dev),
                _replica(replicas, dictv, dev), dl, int(wsize), out_cap)
            outs.append(out[:, IT._DPAD:])
            bads.append(bad.to(torch.uint8))
        return shards.gather(outs), shards.gather(bads).astype(bool)

    return step


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    """x with zero rows appended up to `rows`."""
    if x.shape[0] == rows:
        return x
    return np.concatenate([x, np.zeros((rows - x.shape[0],) + x.shape[1:],
                                       x.dtype)])


def decompress_segments_multichip(blob: bytes, start_bytes, devices=None,
                                  group=None) -> list[bytes]:
    """Sharded counterpart of `ops/inflate.py:decompress_segments_cuda`:
    decode independent full-flush segments with phase A lanes and phase B
    segments split across the shards (devices, group as in
    `compress_multichip`). Falls back to the single-device engine only on
    speculative-decode anomalies (`_Fallback`); a stream error
    (InflateError) raised by the sharded decode propagates, as in the
    reference."""
    shards = visible_shards(devices, group)
    ndev = shards.count
    pa_cache: dict = {}
    pb_cache: dict = {}
    ran = {"a": False, "b": False}

    def phase_a_fn(comp_j, byte_starts, lits, dists, start_bits, lm, dm,
                   cb, lit_cap, dist_cap):
        ran["a"] = True
        B = byte_starts.shape[0]
        Bp = -(-B // ndev) * ndev
        key = (cb, lit_cap, dist_cap)
        if key not in pa_cache:
            pa_cache[key] = make_decode_phase_a(shards, cb, lit_cap,
                                                dist_cap)
        outs = pa_cache[key](comp_j, *(_pad_rows(x, Bp) for x in (
            byte_starts, lits, dists, start_bits, lm, dm)))
        return tuple(o[:B] for o in outs)

    def phase_b_fn(kinds, auxs, olens, comp_j, dictv_j, dict_lens, wsize,
                   out_cap):
        ran["b"] = True
        S = kinds.shape[0]
        Sp = -(-S // ndev) * ndev
        if out_cap not in pb_cache:
            pb_cache[out_cap] = make_decode_phase_b(shards, out_cap)
        out, bad = pb_cache[out_cap](
            _pad_rows(kinds, Sp), _pad_rows(auxs, Sp), _pad_rows(olens, Sp),
            comp_j, dictv_j, _pad_rows(dict_lens, Sp), wsize)
        return out[:S], bad[:S]

    blob = bytes(blob)
    try:
        outs, _ = IT._decode_segments(
            blob, [(8 * s, 8 * e if e is not None else None)
                   for s, e in _seg_bounds(start_bytes, len(blob))],
            None, 1 << 15, phase_a_fn, phase_b_fn,
            device=shards.devices[0])
        if ran["a"] and ran["b"]:
            IT.stats["mesh_ok"] += 1
        return outs
    except InflateError:
        IT.stats["error"] = IT.stats.get("error", 0) + 1
        raise
    except IT._Fallback:
        IT.stats["fallback"] += 1
        return IT.decompress_segments_cuda(blob, start_bytes,
                                           device=shards.devices[0])


def _seg_bounds(start_bytes, blob_len):
    """(start byte, next segment's start byte or None) per segment."""
    starts = list(start_bytes)
    out = []
    for i, s in enumerate(starts):
        end = starts[i + 1] if i + 1 < len(starts) else None
        out.append((s, end))
    return out
