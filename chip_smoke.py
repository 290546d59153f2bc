#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (zlibng_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from zlibng_tpu_torch/csrc with nvcc, then drives
the main path first: compress_cuda at levels 6 and 9, then the fixed-tree
quick path (L1, and Z_FIXED at L6), on a seeded corpus of at least 8 MiB.
Each stream must decode with zlib, equal the port's CPU output (on a 1 MiB
prefix and on the whole corpus) and the JAX reference's pinned digest
(`STREAMS`), and the run must go through both kernels. Then a tuned chain
of 128 (the deep probes, inside K1's one launch per lane group) on one
2 MiB lane group, held to the reference's digest too (`DEEP_STREAM`), and
the host encoder's
inputs (level 0, tiny inputs), which must launch no kernel. Then decode:
decompress_indexed_cuda on the whole corpus (stdlib zlib L6 with a full
flush every 1 MiB: on the device path, one K2 launch per phase A
dispatch), decompress_cuda(engine="device") of the port's L1 stream and
zlib's L6 stream on the card, and of the port's L6 stream, which phase A
gives up to the host's serial decoder (a block longer than the largest
lane), framings and options and corrupt streams on a 64 KiB prefix (each
on its asserted route, against zlib and the CPU port), and the device
checksums. Then the host C runtime (built with the system compiler; it
must build): gzip framing of the whole corpus by compress_cuda and its
decode against zlib, and the host CRC-32 and serial decoder timed on their
C and numpy routes. Then the sharded paths at lane_block 65,536 with one
shard and with 8 shards on the card: compress_multichip on the whole
corpus (zlib round trip, K1 and K2 counted by the wrappers and by the
profiler, equal to the CPU port's sharded run on a 1 MiB prefix),
decompress_segments_multichip of the indexed blob (equal to
decompress_segments_cuda, and a corrupt blob raising the reference's
text), and parallel.multihost over NCCL at world size 1 (the box has one
card). Then the public surface, where it reaches the card: minigzip -t at
L6 and L1 on the corpus, in-process and as a new process (each .gz equal
to compress_cuda(data, level, wbits=31), K1 and K2 counted, decoded by
the port's minigzip -d and by Python's gzip), compress_indexed of the
first 2 MiB on the host Deflate (held to the reference's digest,
`INDEXED_STREAM`) decoded by decompress_indexed_cuda on the device route,
and host round trips of pyzlib, zng, gzopen and Deflate/Inflate.sync,
which must launch no kernel.
Then it holds each kernel (K1 probe walk, K2 parse walk) against its
plain PyTorch version at the main path's shapes (K1 at dense 16, 64 and 2
and at the chain-128 tune, where it also takes the deep probes, and on
adversarial lanes: zeros, random bytes, periodic text, two symbols and
same-hash runs around its halo, with every history bound, encode range
and chain of WALK_CASES; K2 also on raw steps, on
step arrays that defeat its speculation or test its step arithmetic, on
edge bounds, and on decode phase A's bit steps at 16 lanes of 1,048,576
bits), and last runs torch.profiler: K1's device time per operating
point (one kernel per call), K2's device time by phase, the plain deep
probes' launches, one lane group at L6, L1 and Z_FIXED (with stage 1's
share of its launches, counted in the same session), and one warm indexed
decode (device events, idle share, top kernels). Prints
per-phase seconds, per-kernel timings, a `kernels` JSON line, the card's
name and power limit, and as its last line {"ok": true, "device": {...}}.
Exits non-zero, without that line, when any phase fails or no CUDA device
is present. Imports nothing of JAX.
"""
from __future__ import annotations

import gzip
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20261016
CORPUS_MIB = 8.5
# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bandwidth,
# and int32 issue = 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations of one (row, k) probe of a dense sweep that probes every
# row `dense` times (K1's first design): 4 xors, 4 byte-ctz (test, ffs,
# shift), 3 selects, hash compare, distance, 3 range tests, score, best
# compare/update. Printed beside K1's byte bound, as that design's cost
PROBE_OPS = 32
# operations of one K2 stop: store, load, max, add, compare
PARSE_OPS = 5
# compress_tpu's streams of the corpus, (bytes, sha256[:16]) by (level,
# strategy), from the JAX reference on the CPU; the slow test of
# tests/test_torch_chip_corpus.py recomputes them
STREAMS = {(6, 0): (3703261, "b2e5193bf13fdc9f"),
           (9, 0): (3680619, "edbde05b1a5bf4d1"),
           (1, 0): (4689779, "e34f059d648156fb"),
           (6, 4): (4519653, "1be0edb528b1f41a")}
# the indexed decode's segment (compress_indexed's default)
DECODE_SEGMENT = 1 << 20
# the deep-probe phase's tune: chain 128 = K1's 64 dense probes + 64 deep
DEEP_TUNE = dict(chain=128, lazy=True, max_lazy=258, nice=258, good=12)
# compress_tpu's stream of the corpus's first 2 MiB at L6 with DEEP_TUNE
# (bytes, sha256[:16]), recomputed by the same slow test
DEEP_STREAM = (642885, "f9643b06c189beb8")
# the public surface phase's compress_indexed: the corpus's first 2 MiB at
# level 6 with a full flush every 256 KiB (8 segments), on the host Deflate;
# the reference's blob of it (bytes, sha256[:16]), recomputed by the slow
# test of tests/test_torch_isolation.py
INDEXED_PREFIX = 2 << 20
INDEXED_SEGMENT = 1 << 18
INDEXED_STREAM = (661103, "e1317ab56746f4ce")
# the public surface phase's host round trips: a prefix of the corpus
HOST_SURFACE_BYTES = 1 << 18


def _rand64(seed: int, stream: int, n: int) -> np.ndarray:
    """n pseudo-random uint64 (splitmix64 over a counter): integer
    arithmetic only, so every machine and NumPy version makes the same
    corpus (NumPy's distribution samplers may change between versions)."""
    with np.errstate(over="ignore"):
        z = ((np.arange(n, dtype=np.uint64) + np.uint64(stream << 40))
             * np.uint64(0x9E3779B97F4A7C15) + np.uint64(seed))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def corpus(seed: int = SEED, mib: float = CORPUS_MIB) -> tuple[bytes, list]:
    """In-repo fixtures plus seeded synthetic text, binary and runs."""
    fx = ROOT / "tests" / "fixtures"
    parts = [
        ("fixture GH-979/pigz-2.6.tar (gunzipped)",
         gzip.decompress((fx / "GH-979" / "pigz-2.6.tar.gz").read_bytes())),
        ("fixture GH-751/test.txt", (fx / "GH-751" / "test.txt").read_bytes()),
        ("fixture CVE-2018-25032/default.txt",
         (fx / "CVE-2018-25032" / "default.txt").read_bytes()),
    ]
    # text: words from a 6000-word vocabulary (letters skewed toward the
    # common ones), ranks skewed toward the first words, with punctuation
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    skew = np.repeat(np.arange(26), np.arange(26, 0, -1))    # 351 slots
    r = _rand64(seed, 0, 6000 * 11)
    lens = 2 + (r[:6000] % np.uint64(9)).astype(np.int64)
    picks = letters[skew[(r[6000:] % np.uint64(skew.size)).astype(np.int64)]]
    vocab = [picks[10 * i: 10 * i + n].tobytes() for i, n in enumerate(lens)]
    r = _rand64(seed, 1, 2 * 900_000)
    ranks = ((r[:900_000] % np.uint64(6000))
             >> (r[900_000:] % np.uint64(12))).astype(np.int64)
    seps = [b" ", b" ", b" ", b" ", b", ", b". ", b".\n"]
    sep_i = (_rand64(seed, 2, ranks.size) % np.uint64(7)).astype(np.int64)
    text = b"".join(vocab[w] + seps[i]
                    for w, i in zip(ranks.tolist(), sep_i.tolist()))
    parts.append(("synthetic text (skewed words)", text[: 4 << 20]))
    r = _rand64(seed, 3, 1 << 20)
    parts.append(("synthetic binary: uniform random bytes",
                  (r & np.uint64(0xFF)).astype(np.uint8).tobytes()))
    parts.append(("synthetic binary: 16-symbol alphabet",
                  (r >> np.uint64(60)).astype(np.uint8).tobytes()))
    steps = (_rand64(seed, 4, 1 << 17) % np.uint64(300)).astype(np.uint32)
    parts.append(("synthetic binary: little-endian u32 counters",
                  np.cumsum(steps, dtype=np.uint32).astype("<u4").tobytes()))
    r = _rand64(seed, 5, 1 << 14)
    reps = 1 + ((r >> np.uint64(8)) % np.uint64(79)).astype(np.int64)
    runs = np.repeat((r & np.uint64(0xFF)).astype(np.uint8), reps)
    parts.append(("synthetic runs (1-79 bytes)", runs.tobytes()[: 512 << 10]))
    used = sum(len(p) for _, p in parts)
    parts.append(("zeros", bytes(max(0, int(mib * (1 << 20)) - used))))
    return b"".join(p for _, p in parts), [(k, len(p)) for k, p in parts]


# K1's walk cases, (dense, chain, good_l16, max_dist): each runs every lane
# of walk_lanes at once (tests/test_torch_probe_walk.py runs them too)
WALK_CASES = {
    "dense 2 (L1)": (2, 2, 8, 32768),
    "dense 16 (L6)": (16, 16, 12, 32768),
    "dense 64 (L9)": (64, 64, 12, 32768),
    "chain 65": (64, 65, 12, 32768),
    "chain 128": (64, 128, 12, 32768),
    "chain 128, windowBits 9": (64, 128, 12, 512),
    "chain 1024, good 16": (64, 1024, 16, 32768),
    "chain 2048, good 4": (64, 2048, 4, 32768),
}
# a short K1 halo (ops/probe.py:HALO stages up to 1024 rows), with which
# the checks also run chains beyond it, so that deep probes take the
# kernel's global-memory path
SHORT_HALO = 64
# same-hash run lengths of the "halo runs" lane: the short halo and one and
# two rows more, so that the deepest row of the last walks past it
HALO_RUNS = (SHORT_HALO, SHORT_HALO + 1, SHORT_HALO + 2)


def _hashes(lane: np.ndarray) -> np.ndarray:
    """The 16-bit hash of the 4-byte word at every offset of `lane` (the
    last three read zero padding), as ops/lz77.py computes it."""
    from zlibng_tpu_torch.lz77.engine import HASH_MULT
    d = np.concatenate([lane, np.zeros(3, np.uint8)]).astype(np.uint64)
    w = d[:-3] | (d[1:-2] << 8) | (d[2:-1] << 16) | (d[3:] << 24)
    return ((w * np.uint64(HASH_MULT)) & np.uint64(0xFFFFFFFF)) >> 16


def _halo_runs_lane(n: int) -> np.ndarray:
    """Zeros but for its last few KiB: one 4-byte token per run length of
    HALO_RUNS, each token repeated that many times, 12 bytes apart, and
    followed each time by 8 random bytes, so that its rows neither saturate
    nor stop early: the token's same-hash run is exactly that long (tokens
    are drawn until no other word of the lane shares a token's hash). The
    tokens lie in the lane's payload, in one window."""
    gap = 12
    for attempt in range(64):
        r = _rand64(SEED, 8 + attempt, n + 4)
        lane = np.zeros(n, np.uint8)
        tokens = []
        at = n - 16 - gap * sum(HALO_RUNS)
        for i, count in enumerate(HALO_RUNS):
            tok = r[n + i].astype(np.uint32) | np.uint32(0x01010101)
            tokens.append(np.array([tok], "<u4").view(np.uint8))
            for _ in range(count):
                lane[at: at + 4] = tokens[-1]
                lane[at + 4: at + 12] = (r[at: at + 8]
                                         & np.uint64(0xFF)).astype(np.uint8)
                at += gap
        h = _hashes(lane)
        hs = _hashes(np.concatenate(tokens))[[0, 4, 8]]
        if all(int((h == v).sum()) == c for v, c in zip(hs, HALO_RUNS)):
            return lane
    raise AssertionError("no token set gives exact halo runs")


def walk_lanes(n: int) -> dict:
    """K1's adversarial lanes of n bytes: name -> (n,) uint8."""
    r = _rand64(SEED, 7, n)
    return {
        "zeros": np.zeros(n, np.uint8),            # one run, saturates at k=1
        "uniform random": (r & np.uint64(0xFF)).astype(np.uint8),
        "period 3": np.resize(np.frombuffer(b"the", np.uint8), n),
        "period 4": np.resize(np.frombuffer(b"abc ", np.uint8), n),
        # two symbols: runs far past any chain, probes that stay short
        "two symbols": (97 + (r >> np.uint64(60)) % np.uint64(2)).astype(
            np.uint8),
        "halo runs": _halo_runs_lane(n),
    }


def walk_inputs(n: int, hist: int, case: int, dev,
                extra: dict | None = None) -> tuple:
    """K1's inputs for every lane of walk_lanes(n) and of `extra` (name ->
    (n,) uint8), sorted by sorted_probe_rows: (names, w2_s, h_s, pos_s, hv,
    enc_end). Lane i gets hist_valid_from 0, `hist` or hist // 2 and
    enc_end n, n - 333 or the payload's middle, turning with `case` so that
    every lane meets every value over three cases."""
    from zlibng_tpu_torch.ops import lz77
    lanes = dict(walk_lanes(n), **(extra or {}))
    names = list(lanes)
    data = torch.from_numpy(np.stack([lanes[k] for k in names])).to(dev)
    B = data.shape[0]
    pad = torch.cat([data, data.new_zeros((B, 16))], 1)
    w2_s, h_s, pos_s, _ = lz77.sorted_probe_rows(lz77._build_w4(pad), n)
    hvs, ends = (0, hist, hist // 2), (n, n - 333, (n + hist) // 2)
    hv = torch.tensor([hvs[(i + case) % 3] for i in range(B)],
                      dtype=torch.int32, device=dev)
    enc_end = torch.tensor([ends[(i + 2 * case) % 3] for i in range(B)],
                           dtype=torch.int32, device=dev)
    return names, w2_s, h_s, pos_s, hv, enc_end


def _reset_launches(*kernels: str) -> None:
    """Sets the named kernels' launch counts (`probe.launches` and the
    like, read from `_build.launches`) to 0."""
    from zlibng_tpu_torch import _build
    _build.launches.update(dict.fromkeys(kernels, 0))


def timed(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps warm runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def first_group_lanes(data: bytes, dev) -> torch.Tensor:
    """The main path's first lane group: 8 lanes of 32 KiB history plus
    256 KiB payload (N = 294,912), as compress_cuda lays them out."""
    from zlibng_tpu_torch.ops.deflate import LANE_BLOCKS, LANE_HIST
    lb = LANE_BLOCKS[-1]
    vbuf = np.concatenate([np.zeros(LANE_HIST, np.uint8),
                           np.frombuffer(data, np.uint8)])
    lanes = np.stack([vbuf[i * lb: i * lb + LANE_HIST + lb] for i in range(8)])
    return torch.from_numpy(lanes).to(dev)


def walk_probe_bound(h_s: torch.Tensor, chain: int) -> int:
    """The most probes K1's walk can make over (B, n) (hash, pos)-sorted
    rows: each row's offset in its same-hash run plus the probe that meets
    the run's start, at most `chain` and the rows before it."""
    B, n = h_s.shape
    r = torch.arange(n, device=h_s.device).expand(B, n)
    start = torch.ones((B, n), dtype=torch.bool, device=h_s.device)
    start[:, 1:] = h_s[:, 1:] != h_s[:, :-1]
    off = r - torch.where(start, r, 0).cummax(1).values
    return int(torch.minimum((off + 1).clamp(max=chain), r).sum())


def _k1_bytes(B: int, N: int, W: int, deep: bool) -> int:
    """K1's traffic: each row's W + 2 int32 planes read once and its two
    int32 results written once, plus hist_valid_from (and enc_end)."""
    return B * N * ((W + 2) * 4 + 8) + 4 * B * (2 if deep else 1)


def k1_points() -> list:
    """K1's operating points on the main path: (name, level or None,
    chain, good) for L6, L9, L1 and the deep-probe phase's tune."""
    from zlibng_tpu_torch.stream.deflate import LEVELS
    return [(f"dense {LEVELS[lv].chain} (L{lv})", lv, LEVELS[lv].chain,
             LEVELS[lv].good) for lv in (6, 9, 1)] + [
        (f"chain {DEEP_TUNE['chain']} (tune)", None, DEEP_TUNE["chain"],
         DEEP_TUNE["good"])]


def check_k1(lanes: torch.Tensor, rows: list) -> tuple:
    """K1 against its plain version (the dense sweep, then the deep probes)
    at L6's, L9's and L1's operating points (dense 16, 64 and 2) and at the
    deep-probe phase's tune (chain 128: 64 dense and 64 deep probes in one
    launch), with both times, the byte bound and the probes each makes;
    then the chain-128 walk with a halo of 64 rows (its deep probes read
    global memory) against the default halo.
    Returns its inputs for the later phases."""
    from zlibng_tpu_torch.ops import lz77, probe
    from zlibng_tpu_torch.ops.deflate import LANE_HIST
    B, N = lanes.shape
    pad = torch.cat([lanes, lanes.new_zeros((B, 16))], 1)
    w2_s, h_s, pos_s, _ = lz77.sorted_probe_rows(lz77._build_w4(pad), N)
    hv = torch.zeros(B, dtype=torch.int32, device=lanes.device)
    hv[0] = LANE_HIST
    enc_end = torch.full((B,), N, dtype=torch.int32, device=lanes.device)
    W = w2_s.shape[2]
    for name, lv, chain, good in k1_points():
        dense = min(chain, lz77.DENSE_PROBES)
        args = (w2_s, h_s, pos_s, hv, dense, lz77.GATE_DEPTH,
                max(4, min(good, 16)), 32768)
        tail = (chain, LANE_HIST, enc_end)
        ks, kc = probe.probe_best(*args, chain=chain, enc_start=LANE_HIST,
                                  enc_end=enc_end)
        lz77.deep_stats.update(rows=0, chunks=0)
        ps, pc = probe._probe_plain(*args, *tail)
        torch.cuda.synchronize()
        needy = lz77.deep_stats["rows"]
        err = max(int((ks.long() - ps.long()).abs().max()),
                  int((kc.long() - pc.long()).abs().max()))
        if err != 0:
            raise AssertionError(f"K1 {name}: kernel != plain (max abs err "
                                 f"{err}, {int((ks != ps).sum())} scores "
                                 f"differ)")
        ms = timed(lambda: probe.probe_best(*args, chain=chain,
                                            enc_start=LANE_HIST,
                                            enc_end=enc_end), 20)
        plain_ms = timed(lambda: probe._probe_plain(*args, *tail), 3)
        b_ms, by = bound(_k1_bytes(B, N, W, chain > dense), 0)
        swept = B * N * dense + needy * (chain - dense)
        walk = walk_probe_bound(h_s, chain)
        old_ops_ms = B * N * dense * PROBE_OPS / INT32_OPS_PER_S * 1e3
        print(f"K1 probe_best B={B} N={N} W={W} {name}: equal to plain; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, byte bound "
              f"{b_ms:.4f} ms ({b_ms / ms:.1%} of it reached); probes: plain "
              f"sweep {swept} ({needy} needy rows x {chain - dense} deep), "
              f"walk at most {walk}; the dense sweep's {PROBE_OPS} ops per "
              f"probe would take {old_ops_ms:.4f} ms", flush=True)
        rows.append(dict(name=name, level=lv, dense=dense, chain=chain,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=by, plain_probes=swept,
                         needy=needy, walk_bound=walk,
                         run=lambda a=args, c=chain: probe.probe_best(
                             *a, chain=c, enc_start=LANE_HIST,
                             enc_end=enc_end)))
    # the halo: rows staged in shared memory; deeper probes read L2
    dense, chain = lz77.DENSE_PROBES, DEEP_TUNE["chain"]
    args = (w2_s, h_s, pos_s, hv, dense, lz77.GATE_DEPTH,
            max(4, min(DEEP_TUNE["good"], 16)), 32768, chain, LANE_HIST,
            enc_end)
    want = probe._probe_plain(*args)
    for halo in (SHORT_HALO, probe.HALO):
        got = probe._probe_best_cuda(*args, halo=halo)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K1 chain {chain}, halo {halo}: kernel != "
                                 "plain")
        ms = timed(lambda: probe._probe_best_cuda(*args, halo=halo), 20)
        print(f"K1 chain {chain} with a halo of {halo} rows: equal to plain; "
              f"kernel {ms:.4f} ms", flush=True)
    return w2_s, h_s, pos_s, hv, enc_end


def check_k1_walk() -> None:
    """K1 against its plain version on the adversarial lanes of walk_lanes
    at the main path's lane size, each through sorted_probe_rows: every
    case of WALK_CASES, with hist_valid_from and enc_end turned three
    times, and chains beyond SHORT_HALO with that halo too (the deep probes
    from global memory). Any difference fails; prints each case's kernel
    time (median of 5, default halo) and its walk's probe bound."""
    from zlibng_tpu_torch.ops import lz77, probe
    from zlibng_tpu_torch.ops.deflate import LANE_BLOCKS, LANE_HIST
    n = LANE_HIST + LANE_BLOCKS[-1]
    dev = torch.device("cuda")
    for turn in range(3):
        names, *ins = walk_inputs(n, LANE_HIST, turn, dev)
        w2_s, h_s, pos_s, hv, enc_end = ins
        for case, (dense, chain, good, max_dist) in WALK_CASES.items():
            args = (w2_s, h_s, pos_s, hv, dense, lz77.GATE_DEPTH, good,
                    max_dist)
            kw = dict(chain=chain, enc_start=LANE_HIST, enc_end=enc_end)
            ps, pc = probe._probe_plain(*args, chain, LANE_HIST, enc_end)
            halos = (probe.HALO, SHORT_HALO) if chain > SHORT_HALO else (
                probe.HALO,)
            for halo in halos:
                ks, kc = probe._probe_best_cuda(*args, chain, LANE_HIST,
                                                enc_end, halo=halo)
                torch.cuda.synchronize()
                bad = [names[i] for i in range(len(names))
                       if not (torch.equal(ks[i], ps[i])
                               and torch.equal(kc[i], pc[i]))]
                if bad:
                    raise AssertionError(f"K1 walk {case}, turn {turn}, halo "
                                         f"{halo}: kernel != plain on lanes "
                                         f"{bad}")
            ms = timed(lambda: probe.probe_best(*args, **kw), 5)
            print(f"K1 walk {case}, turn {turn} (hist_valid_from "
                  f"{hv.tolist()}, enc_end {enc_end.tolist()}): equal to "
                  f"plain on {len(names)} lanes of {n} B ({', '.join(names)}"
                  f"); kernel {ms:.4f} ms; walk at most "
                  f"{walk_probe_bound(h_s, chain)} probes", flush=True)


def time_deep_probes(k1_inputs: tuple) -> dict:
    """The plain deep probes of the deep-probe phase's tune on the first
    lane group, after K1's 64 dense probes (the second half of K1's plain
    version, which the walk takes over on the card): needy rows, chunks
    and ms per call between CUDA events."""
    from zlibng_tpu_torch.ops import lz77, probe
    from zlibng_tpu_torch.ops.deflate import LANE_HIST
    w2_s, h_s, pos_s, hv, enc_end = k1_inputs
    B, N = h_s.shape
    good = DEEP_TUNE["good"]
    score, cand = probe.probe_best(w2_s, h_s, pos_s, hv, lz77.DENSE_PROBES,
                                   lz77.GATE_DEPTH, good, 32768)
    args = (w2_s, h_s, pos_s, hv)
    tail = (LANE_HIST, enc_end.reshape(B, 1), lz77.DENSE_PROBES,
            DEEP_TUNE["chain"], good, 32768)
    lz77.deep_stats.update(rows=0, chunks=0)
    lz77.deep_probes(*args, score.clone(), cand.clone(), *tail)
    stats = dict(lz77.deep_stats)
    ms = timed(lambda: lz77.deep_probes(*args, score.clone(), cand.clone(),
                                        *tail), 5)
    print(f"plain deep probes (chain {DEEP_TUNE['chain']}) on the first group "
          f"B={B} N={N}: {stats['rows']} needy rows x {stats['k_steps']} "
          f"probes in {stats['chunks']} chunks; {ms:.4f} ms per call",
          flush=True)
    return dict(stats, ms=ms, run=lambda: lz77.deep_probes(
        *args, score.clone(), cand.clone(), *tail))


def device_ms(fn, reps: int, match: str) -> dict | None:
    """Per-call device time (ms) of each CUDA kernel whose name holds
    `match`, from torch.profiler over reps warm calls; None if the profiler
    saw no device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in p.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and match in e.name):
            name = e.name.split("::")[-1].split("(")[0]
            out[name] = out.get(name, 0.0) + e.device_time / 1e3 / reps
    return out or None


def _k2_case(name: str, step: torch.Tensor, bounds: torch.Tensor,
             reps: int = 20) -> dict:
    """Holds K2 exactly equal to its plain version on one input, on an
    output block poisoned beforehand so that an unwritten byte shows, and
    times both per call between CUDA events."""
    from zlibng_tpu_torch.ops import parse
    B, N = step.shape
    # a freed block of the output's size, full of 0xAB, for sel to reuse
    torch.full((B, N), 0xAB, dtype=torch.uint8, device=step.device)
    ks, stats = parse._parse_select_cuda(step, bounds)
    ps = parse._parse_select_plain(step, bounds)
    torch.cuda.synchronize()
    top = int(ks.view(torch.uint8).max())
    if ks.dtype != torch.bool or top > 1:
        raise AssertionError(f"K2 {name}: mask is not 0/1 bool "
                             f"({ks.dtype}, max byte {top})")
    err = int((ks.long() - ps.long()).abs().max())
    if err != 0:
        raise AssertionError(f"K2 {name}: kernel != plain (max abs err {err}, "
                             f"{int((ks != ps).sum())} positions differ)")
    stops = int(ps.sum())
    ms = timed(lambda: parse._parse_select_cuda(step, bounds), reps)
    plain_ms = timed(lambda: parse._parse_select_plain(step, bounds), 3)
    rep, clr = (int(v) for v in stats.sum(0))
    b_ms, by = bound(4 * stops + B * N + 8 * B, PARSE_OPS * stops)
    print(f"K2 {name} B={B} N={N}: equal to plain; {stops} stops; kernel "
          f"{ms:.4f} ms per call; plain {plain_ms:.4f} ms; bound {b_ms:.4f} "
          f"ms ({by}); segments repaired {rep}, cleared {clr}", flush=True)
    return dict(name=name, step=step, bounds=bounds, reps=reps,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, stops=stops, repaired=rep, cleared=clr,
                per_lane=stats.tolist(), stops_per_lane=ps.sum(1).tolist())


def _k2_adversarial(B: int, N: int, dev) -> dict:
    """Step arrays that defeat speculation or test the step arithmetic."""
    from zlibng_tpu_torch.ops import parse
    r = _rand64(SEED, 6, 3 * B * N).reshape(3, B, N)
    lit_match = np.where(r[0] % np.uint64(10) < np.uint64(3),
                         3 + (r[1] % np.uint64(256)).astype(np.int64), 1)
    rare = r[2] % np.uint64(1000) == np.uint64(0)
    neg = -1 - (r[2] >> np.uint64(33)).astype(np.int64)   # down to -2**31
    arrays = {
        "all-3": np.full((B, N), 3),
        "all-258": np.full((B, N), 258),
        "zeros": np.zeros((B, N)),
        "negative": np.where(r[2] % np.uint64(2) == np.uint64(0), neg,
                             lit_match),
        "1<<26 sprinkled": np.where(rare, 1 << 26, lit_match),
        "all 1<<26": np.full((B, N), 1 << 26),
        "2**31-1 sprinkled": np.where(rare, 2 ** 31 - 1, lit_match),
    }
    out = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
           for k, v in arrays.items()}
    out["all-literal fused"] = parse.fused_steps(
        torch.ones((B, N), dtype=torch.int32, device=dev))
    return out


def check_k2_decode(wave: tuple, rows: list, launches: int) -> dict:
    """K2 on decode phase A's bit steps (indexed_decode's wave): equal to
    its plain version; stops, repaired and cleared segments per lane."""
    step, bounds = wave
    row = _k2_case("decode bit-steps, indexed, cb 131072", step, bounds)
    print("K2 decode bit-steps per lane (stops, repaired, cleared): "
          + "; ".join(f"{s} {r} {c}" for s, (r, c) in
                      zip(row["stops_per_lane"], row["per_lane"])),
          flush=True)
    rows.append(dict(row, launches=launches))
    return row


def check_k2(lanes: torch.Tensor, rows: list) -> list:
    """K2 against its plain version on the main path's fused steps at L6,
    L9 and L1 (un-lazy, nice 16) and raw steps at L6 and L9, on
    adversarial steps and on edge bounds; the whole
    encode-path parse checked and timed. Appends the main-path rows to
    `rows`; returns every case, and the encode parse's, for profile_k2."""
    from zlibng_tpu_torch.ops import lz77, parse
    from zlibng_tpu_torch.ops.deflate import LANE_HIST, UNIT
    from zlibng_tpu_torch.stream.deflate import LEVELS
    B, N = lanes.shape
    dev = lanes.device
    enc_end = torch.full((B,), N, dtype=torch.int32, device=dev)
    hv = torch.zeros(B, dtype=torch.int32, device=dev)
    hv[0] = LANE_HIST
    bounds = torch.stack([torch.full_like(enc_end, LANE_HIST), enc_end],
                         1).contiguous()
    raw = {}
    for lv in (6, 9, 1):
        lc = LEVELS[lv]
        core = lz77.lz77_lane(lanes, LANE_HIST, enc_end, hv, lc.chain,
                              lc.lazy, lc.max_lazy, lc.nice, unit=UNIT,
                              good=lc.good)
        raw[lv] = core["step"].contiguous()
    fused = {lv: parse.fused_steps(step).contiguous()
             for lv, step in raw.items()}
    cases = []
    for lv in (6, 9, 1):
        row = _k2_case(f"L{lv} fused steps", fused[lv], bounds)
        rows.append(dict(row, level=lv))
        cases.append(row)
    for lv in (6, 9):
        cases.append(_k2_case(f"L{lv} raw steps", raw[lv], bounds))
    for name, step in _k2_adversarial(B, N, dev).items():
        cases.append(_k2_case(name, step, bounds, reps=5))
    S = parse.SEG
    edge = torch.tensor([[LANE_HIST, N], [0, N], [5000, 5000], [0, 0],
                         [S + 953, 2 * S - 49], [100, N - 777], [N - 1, N],
                         [12345, 200001]], dtype=torch.int32, device=dev)
    print(f"K2 edge bounds: {edge.tolist()}", flush=True)
    for name, step in (("L6 fused", fused[6]), ("L6 raw", raw[6]),
                       ("all-3", torch.full_like(raw[6], 3))):
        cases.append(_k2_case(f"{name}, edge bounds", step, edge, reps=5))
    for lv in (6, 9):
        enc = parse.parse_select_encode(raw[lv], bounds)
        if not torch.equal(enc, parse._parse_select_plain(raw[lv], bounds)):
            raise AssertionError(f"L{lv}: parse_select_encode != plain walk")
        ms = timed(lambda: parse.parse_select_encode(raw[lv], bounds), 20)
        print(f"parse_select_encode L{lv} (fused steps, K2, cover) B={B} "
              f"N={N}: equal to the plain walk; {ms:.4f} ms per call",
              flush=True)
        cases.append(dict(name=f"parse_select_encode L{lv}", step=raw[lv],
                          bounds=bounds, reps=20, encode=True))
    return cases


def profile_k2(cases: list, rows: list) -> None:
    """Device time per call of K2's two launches (and, for the encode
    parse, of all its kernels) under torch.profiler, for every case of
    check_k2. Runs after the main path. Sets `device_ms` in the main-path
    rows: the sum of K2's phases, or None where the profiler saw nothing."""
    from zlibng_tpu_torch.ops import parse
    for c in cases:
        step, bounds = c["step"], c["bounds"]
        if c.get("encode"):
            dev = device_ms(lambda: parse.parse_select_encode(step, bounds),
                            c["reps"], "")
            if dev is None:
                print(f"{c['name']}: device time not measured", flush=True)
                continue
            k2 = sum(v for k, v in dev.items() if k.startswith("parse_"))
            print(f"{c['name']}: device {sum(dev.values()):.4f} ms per call "
                  f"in {len(dev)} kernels, K2 {k2:.4f} ms of it", flush=True)
            continue
        dev = device_ms(lambda: parse._parse_select_cuda(step, bounds),
                        c["reps"], "parse_")
        if dev is None:
            print(f"K2 {c['name']}: device time not measured", flush=True)
        else:
            print(f"K2 {c['name']}: device {sum(dev.values()):.4f} ms per "
                  f"call (" + ", ".join(f"{k} {v:.4f}" for k, v in
                                        dev.items()) + ")", flush=True)
        for row in rows:
            if row["name"] == c["name"]:
                row["device_ms"] = sum(dev.values()) if dev else None


def check_estimate(lanes: torch.Tensor) -> None:
    """The float32 entropy of the partition estimate (ops/deflate.py:_ent)
    on the card and on the host, for the first group's per-unit symbol
    counts: the reason the port computes the estimate on the host."""
    from zlibng_tpu_torch.ops import deflate as tdef
    B, N = lanes.shape
    lb = N - tdef.LANE_HIST
    flat = torch.cat([lanes[0], lanes[1:, tdef.LANE_HIST:].reshape(-1)])
    enc = torch.full((B,), N, dtype=torch.int32, device=lanes.device)
    hv = torch.zeros_like(enc)
    hv[0] = tdef.LANE_HIST
    _, lf, df = tdef._stage1(flat, enc, hv, lb, 16, True, 32, 128, 0, 12)
    diff = total = 0
    for f in (lf, df):
        card = tdef._ent(f, f.sum(-1, keepdim=True).to(torch.float32))
        fh = f.cpu()
        host = tdef._ent(fh, fh.sum(-1, keepdim=True).to(torch.float32))
        diff += int((card.cpu().view(torch.int32)
                     != host.view(torch.int32)).sum())
        total += host.numel()
    print(f"estimate: {diff} of {total} per-unit float32 entropies differ in "
          f"bits between the card and the host", flush=True)


def _name(level: int, strategy: int) -> str:
    return f"L{level}" + (" Z_FIXED" if strategy == 4 else "")


def main_path(data: bytes, level: int, strategy: int = 0) -> dict:
    """compress_cuda on the whole corpus: cold and warm runs with the
    launch counters read around the cold one, zlib round trip, equality
    with the CPU port (1 MiB prefix, whole corpus) and with the
    reference's pinned digest."""
    from zlibng_tpu_torch import compress_cuda
    from zlibng_tpu_torch.ops import deflate, huffman, parse, probe
    name = _name(level, strategy)
    kw = dict(strategy=strategy)
    _reset_launches("probe", "parse", "huffman")
    t0 = time.perf_counter()
    out = compress_cuda(data, level, **kw)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {"K1": probe.launches, "K2": parse.launches}
    if launches["K1"] == 0 or launches["K2"] == 0:
        raise AssertionError(f"{name}: main path missed a kernel {launches}")
    # stage 2 auto builds its trees in the Huffman kernel; the quick path
    # (L1, Z_FIXED) builds none
    huf = huffman.launches
    if (huf > 0) != (level > 1 and strategy != 4):
        raise AssertionError(f"{name}: {huf} Huffman kernel launches")
    if zlib.decompress(out) != data:
        raise AssertionError(f"{name}: zlib round trip failed")
    digest = (len(out), hashlib.sha256(out).hexdigest()[:16])
    if digest != STREAMS[level, strategy]:
        raise AssertionError(f"{name}: stream {digest} differs from "
                             f"compress_tpu's {STREAMS[level, strategy]}")
    t0 = time.perf_counter()
    warm_out = compress_cuda(data, level, **kw)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    stages = dict(deflate.stage_seconds)
    if warm_out != out:
        raise AssertionError(f"{name}: warm run differs from cold run")
    prefix = data[: 1 << 20]
    if compress_cuda(prefix, level, **kw) != compress_cuda(
            prefix, level, device="cpu", **kw):
        raise AssertionError(f"{name}: 1 MiB prefix differs from CPU port")
    t0 = time.perf_counter()
    if compress_cuda(data, level, device="cpu", **kw) != out:
        raise AssertionError(f"{name}: output differs from the CPU port")
    cpu_s = time.perf_counter() - t0
    mbs = len(data) / warm / 1e6
    print(f"main path {name}: {len(data)} B -> {len(out)} B "
          f"(ratio {len(out) / len(data):.4f}, sha256 {digest[1]}, equal to "
          f"compress_tpu's); zlib round trip ok; equal to the CPU port on "
          f"the 1 MiB prefix and on the whole corpus ({cpu_s:.1f} s on the "
          f"host); launches {launches}, Huffman {huf}; cold {cold:.3f} s, "
          f"warm {warm:.3f} s "
          f"= {mbs:.3f} MB/s; warm stages: stage1 {stages['stage1']:.3f} s, "
          f"stage2 {stages['stage2']:.3f} s, stitch {stages['stitch']:.3f} s",
          flush=True)
    return dict(level=level, launches=launches, huffman_launches=huf,
                size=len(out), warm_s=warm, mb_s=mbs, stages=stages,
                stream=out)


def huffman_groups(data: bytes, device="cuda") -> list:
    """(lfreq, dfreq, btype_bits, outputs) of every lane group's Huffman
    build (`huff_build`) in an L6 compress_cuda of data on device."""
    from zlibng_tpu_torch import compress_cuda
    from zlibng_tpu_torch.ops import deflate
    seen = []
    build = deflate.huff_build

    def record(lfreq, dfreq, btype_bits):
        out = build(lfreq, dfreq, btype_bits)
        seen.append((lfreq.clone(), dfreq.clone(), btype_bits, out))
        return out
    deflate.huff_build = record
    try:
        compress_cuda(data, 6, device=device)
    finally:
        deflate.huff_build = build
    return seen


def check_huffman(data: bytes) -> list:
    """Stage 2's Huffman kernel (csrc/huffman.cu) on the rows of the L6
    call's first lane group (G = 128) and its tail group (G = 32): every
    output equal to the plain version (huff_table x 2 + dyn_header) run on
    the card, and both timed per call between CUDA events."""
    from zlibng_tpu_torch.ops import huffman
    groups = huffman_groups(data)
    rows = []
    for lf, df, bt, got in (groups[0], groups[-1]):
        G = lf.shape[0]
        want = huffman._huff_build_plain(lf, df, bt)
        for k, (a, b) in enumerate(zip(got, want)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"Huffman kernel G={G}: output {k} "
                                     f"differs from the plain version")
        ms = timed(lambda: huffman._huff_build_cuda(lf, df, bt), 50)
        dev = device_ms(lambda: huffman._huff_build_cuda(lf, df, bt), 50,
                        "huff_build")
        plain_ms = timed(lambda: huffman._huff_build_plain(lf, df, bt), 2)
        # bytes: the frequencies read once, every output written once
        nbytes = G * (4 * (286 + 30) + 4 * 2 * (286 + 30)
                      + 12 * huffman.HDR_SLOTS + 4)
        b_ms, by = bound(nbytes, 0)
        dev_ms = sum(dev.values()) if dev else None
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"Huffman kernel G={G}: equal to plain; kernel {ms:.4f} ms per "
              f"call (device {dev_txt}); plain {plain_ms:.2f} ms; bound "
              f"{b_ms:.5f} ms ({by}, {nbytes} B)", flush=True)
        rows.append(dict(G=G, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=by, max_abs_err=0))
    return rows


def check_flat_luts(indexed: dict) -> list:
    """Decode phase A's flat-LUT kernel (csrc/flat_luts.cu) at the indexed
    decode's wave shapes: one warm decompress_indexed_cuda of the corpus
    (the input back, two launches per phase A dispatch), every LUT it built
    equal to the plain version run on the card, then the widest literal
    and distance builds (most lanes times lut_cap, padding lanes included)
    timed per call between CUDA events, the kernel's device time by
    torch.profiler too, and the plain version's."""
    from zlibng_tpu_torch.ops import inflate
    from zlibng_tpu_torch.parallel.index import decompress_indexed_cuda
    build, seen = inflate._build_flat_luts, []

    def keep(tabs, masks, lut_cap):
        out = build(tabs, masks, lut_cap)
        seen.append((tabs.clone(), masks.clone(), lut_cap, out.clone()))
        return out
    inflate._build_flat_luts = keep
    n0 = inflate.launches
    try:
        out = decompress_indexed_cuda(indexed["blob"], indexed["idx"])
    finally:
        inflate._build_flat_luts = build
    torch.cuda.synchronize()
    st = inflate.decode_stats
    launches = inflate.launches - n0
    if out != indexed["data"]:
        raise AssertionError("flat LUTs: the indexed decode's output differs")
    if launches != 2 * st["phase_a"] or launches != len(seen) \
            or st["flat_luts.launches"] != launches:
        raise AssertionError(
            f"flat LUTs: {launches} launches ({len(seen)} builds, counter "
            f"{st.get('flat_luts.launches')}) for {st['phase_a']} phase A "
            f"dispatches, not two each")
    for k, (t, m, cap, got) in enumerate(seen):
        want = inflate._build_flat_luts_plain(t, m, cap)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"flat LUTs: build {k} (B {t.shape[0]}, "
                                 f"lut_cap {cap}) differs from the plain "
                                 f"version")
    rows = []
    # each table's widest build of the call: the most lanes, the widest LUT
    widest = [max(seen[k::2], key=lambda b: (b[0].shape[0] * b[2]))
              for k in (0, 1)]
    for name, (t, m, cap, _) in zip(("literal/length", "distance"), widest):
        B, nsyms = t.shape[0], t.shape[1] - 48
        ms = timed(lambda: inflate._build_flat_luts_cuda(t, m, cap), 200)
        dev = device_ms(lambda: inflate._build_flat_luts_cuda(t, m, cap),
                        200, "flat_luts")
        plain_ms = timed(lambda: inflate._build_flat_luts_plain(t, m, cap),
                         20)
        # bytes: every entry written once, the descriptions and masks read
        nbytes = 4 * B * cap + 4 * B * (48 + nsyms) + 4 * B
        b_ms, by = bound(nbytes, 0)
        dev_ms = sum(dev.values()) if dev else None
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"flat LUT kernel ({name}, B={B}, lut_cap={cap}): equal to "
              f"plain; kernel {ms:.4f} ms per call (device {dev_txt}); plain "
              f"{plain_ms:.3f} ms; bound {b_ms:.5f} ms ({by}, {nbytes} B); "
              f"{launches} launches per indexed decode ({st['phase_a']} "
              f"dispatches)", flush=True)
        rows.append(dict(name=name, B=B, lut_cap=cap, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         launches=launches, max_abs_err=0))
    return rows


def deep_path(data: bytes) -> dict:
    """compress_cuda with a chain-128 tune on the corpus's first 2 MiB
    (one full-width lane group), against the reference's pinned digest
    and the CPU port. On the card K1's walk takes the deep probes: one K1
    launch per lane group and no call of the plain deep probes."""
    from types import SimpleNamespace
    from zlibng_tpu_torch import compress_cuda
    from zlibng_tpu_torch.ops import deflate, lz77, parse, probe
    group = data[: 2 << 20]
    groups = -(-len(group) // deflate.GROUP_BYTES)
    tune = SimpleNamespace(**DEEP_TUNE)
    plain_deep = lz77.deep_probes
    calls = []

    def counted(*a, **k):
        calls.append(a[0].device.type)
        return plain_deep(*a, **k)

    _reset_launches("probe", "parse")
    lz77.deep_probes = counted
    try:
        t0 = time.perf_counter()
        out = compress_cuda(group, 6, tune=tune)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    finally:
        lz77.deep_probes = plain_deep
    launches = {"K1": probe.launches, "K2": parse.launches}
    if launches["K1"] != groups or launches["K2"] == 0 or calls:
        raise AssertionError(f"deep probes: K1 launches {launches['K1']} for "
                             f"{groups} lane group(s), K2 {launches['K2']}, "
                             f"plain deep-probe calls {calls}")
    if zlib.decompress(out) != group:
        raise AssertionError("deep probes: zlib round trip failed")
    digest = (len(out), hashlib.sha256(out).hexdigest()[:16])
    if digest != DEEP_STREAM:
        raise AssertionError(f"deep probes: stream {digest} differs from "
                             f"compress_tpu's {DEEP_STREAM}")
    lz77.deep_stats.update(rows=0, chunks=0)
    if compress_cuda(group, 6, tune=tune, device="cpu") != out:
        raise AssertionError("deep probes: output differs from the CPU port")
    stats = dict(lz77.deep_stats)
    print(f"deep probes, tune {DEEP_TUNE}, first {len(group)} B: -> "
          f"{len(out)} B (sha256 {digest[1]}, equal to compress_tpu's and "
          f"to the CPU port), zlib round trip ok; on the card K1 took the "
          f"deep probes: launches {launches} for {groups} lane group(s), no "
          f"plain deep-probe call; {sec:.3f} s (first call of this tune); "
          f"the CPU port's plain deep probes: {stats['rows']} needy rows x "
          f"{stats['k_steps']} probes in {stats['chunks']} chunks",
          flush=True)
    return launches


def host_route(data: bytes) -> None:
    """Level 0 on the whole corpus and 0, 1 and 1023 bytes at L6 through
    compress_cuda(device="cuda"): the host encoder, no kernel launched."""
    from zlibng_tpu_torch import compress_cuda
    from zlibng_tpu_torch.ops import parse, probe
    _reset_launches("probe", "parse")
    for what, buf, level in (("level 0, whole corpus", data, 0),
                             ("0 B at L6", b"", 6),
                             ("1 B at L6", data[:1], 6),
                             ("1023 B at L6", data[:1023], 6)):
        t0 = time.perf_counter()
        out = compress_cuda(buf, level, device="cuda")
        sec = time.perf_counter() - t0
        if zlib.decompress(out) != buf:
            raise AssertionError(f"host route {what}: zlib round trip failed")
        if compress_cuda(buf, level, device="cpu") != out:
            raise AssertionError(f"host route {what}: differs from CPU port")
        print(f"host route {what}: {len(buf)} B -> {len(out)} B in "
              f"{sec:.3f} s; zlib round trip ok; equal to the CPU port",
              flush=True)
    if probe.launches or parse.launches:
        raise AssertionError(f"host route launched kernels: K1 "
                             f"{probe.launches}, K2 {parse.launches}")
    print("host route: no kernel launched (K1 0, K2 0)", flush=True)


def indexed_blob(data: bytes, segment: int = DECODE_SEGMENT
                 ) -> tuple[bytes, object]:
    """Raw deflate of `data` by stdlib zlib at level 6 with a Z_FULL_FLUSH
    every `segment` bytes, and its StreamIndex (the port's)."""
    from zlibng_tpu_torch.parallel.index import StreamIndex
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    blob = bytearray()
    idx = StreamIndex()
    for pos in range(0, len(data), segment):
        idx.comp_offsets.append(len(blob))
        idx.out_offsets.append(pos)
        last = pos + segment >= len(data)
        blob += co.compress(data[pos:pos + segment]) + co.flush(
            zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH)
    idx.comp_offsets.append(len(blob))
    idx.out_offsets.append(len(data))
    idx.total_out = len(data)
    return bytes(blob), idx


def _decode_run(fn) -> dict:
    """fn() with K2's launch counter set to 0 just before and read just
    after; the change in ops/inflate.py's `stats`, the wave engine's split
    and fallback cause, and the text of the DataError fn raised (None if
    none); wall seconds on the host's clock."""
    from zlibng_tpu_torch.errors import DataError
    from zlibng_tpu_torch.ops import inflate, parse
    before = dict(inflate.stats)
    _reset_launches("parse")
    out = error = None
    t0 = time.perf_counter()
    try:
        out = fn()
    except DataError as e:
        error = str(e)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return dict(out=out, error=error, s=sec, k2=parse.launches,
                stats={k: inflate.stats[k] - before[k] for k in before},
                split=dict(inflate.decode_stats))


def _route(r: dict) -> str:
    """Which route a decode took, from its `stats` change: "device",
    "fallback" (the wave engine gave the stream up to the serial decoder)
    or "host"; AssertionError unless exactly one was counted."""
    names = {"device_ok": "device", "fallback": "fallback",
             "host_routed": "host"}
    taken = [k for k, v in r["stats"].items() if v]
    if len(taken) != 1 or r["stats"][taken[0]] != 1 or taken[0] not in names:
        raise AssertionError(f"decode counted {r['stats']}")
    return names[taken[0]]


def _device_route(name: str, r: dict, cause: str | None = None) -> None:
    """r went through phase A on the card, one K2 launch per dispatch, and
    ended on the device (cause None) or was given up by the wave engine
    for `cause`."""
    route, sp = _route(r), r["split"]
    want = "device" if cause is None else "fallback"
    if route != want or sp["fallback_cause"] != cause:
        raise AssertionError(f"{name}: route {route} ({sp['fallback_cause']})"
                             f", not {want} ({cause})")
    if r["k2"] == 0 or r["k2"] != sp["phase_a"]:
        raise AssertionError(f"{name}: K2 launches {r['k2']} != phase A "
                             f"dispatches {sp['phase_a']}")


def _split(r: dict) -> str:
    sp = r["split"]
    return (f"waves {sp['waves']}, phase A dispatches {sp['phase_a']}, K2 "
            f"launches {r['k2']}; {r['s']:.3f} s = "
            f"{len(r['out']) / r['s'] / 1e6:.3f} MB/s out; split phase A "
            f"{sp['phase_a_s']:.3f} s / phase B {sp['phase_b_s']:.3f} s / "
            f"host {sp['total_s'] - sp['phase_a_s'] - sp['phase_b_s']:.3f} s "
            f"(+ {r['s'] - sp['total_s']:.3f} s outside the wave engine)")


def indexed_decode(data: bytes) -> dict:
    """decompress_indexed_cuda on the whole corpus (9 segments of 1 MiB),
    cold then warm: equal to the corpus, on the device path with no
    fallback, one K2 launch per phase A dispatch. The cold run also keeps
    K2's inputs at the largest lane (cb = 131,072, N = 1,048,576 bits) of
    its first dispatches, and returns 16 real lanes of them (padding lanes
    dropped) as `wave`: K2's decode traffic for check_k2_decode."""
    from zlibng_tpu_torch.ops import inflate, parse
    from zlibng_tpu_torch.parallel.index import decompress_indexed_cuda
    blob, idx = indexed_blob(data)
    sizes = np.diff(idx.comp_offsets).tolist()
    print(f"indexed blob: {len(blob)} B in {len(sizes)} segments of "
          f"{DECODE_SEGMENT} B (stdlib zlib L6, raw, Z_FULL_FLUSH): "
          f"compressed sizes {sizes}", flush=True)
    k2, kept = parse._parse_select_cuda, []
    n_big = 8 * inflate._CB_BUCKETS[-1]

    def keep(step, bounds):
        # padding at most doubles a dispatch: 32 rows hold 16 real lanes
        if step.shape[1] == n_big and sum(s.shape[0] for s, _ in kept) < 32:
            kept.append((step, bounds))
        return k2(step, bounds)

    runs = []
    for run in ("cold", "warm"):
        parse._parse_select_cuda = keep if run == "cold" else k2
        try:
            r = _decode_run(lambda: decompress_indexed_cuda(blob, idx))
        finally:
            parse._parse_select_cuda = k2
        if r["out"] != data:
            raise AssertionError(f"indexed decode ({run}): output differs "
                                 f"from the corpus ({r['error']})")
        _device_route(f"indexed decode ({run})", r)
        print(f"indexed decode ({run}): {len(blob)} B -> {len(r['out'])} B, "
              f"equal to the corpus; stats change {r['stats']}; "
              + _split(r), flush=True)
        runs.append(r)
    # a padding lane (mask 0) decodes every position as invalid: all 1<<26
    step = torch.cat([s for s, _ in kept])
    bounds = torch.cat([b for _, b in kept])
    real = (step != inflate._BIG).any(1)
    if int(real.sum()) < 16:
        raise AssertionError(f"indexed decode: {int(real.sum())} real lanes "
                             f"at cb {inflate._CB_BUCKETS[-1]}, not 16")
    print(f"K2 decode inputs kept from the cold run: {len(kept)} dispatches "
          f"at cb {inflate._CB_BUCKETS[-1]} of {[s.shape[0] for s, _ in kept]}"
          f" lanes, {int(real.sum())} real; the first 16 real", flush=True)
    return dict(blob=blob, idx=idx, launches=runs[0]["k2"],
                warm_s=runs[1]["s"], wave=(step[real][:16].contiguous(),
                                           bounds[real][:16].contiguous()))


def single_decode(data: bytes, streams: dict) -> None:
    """decompress_cuda(engine="device") of whole-corpus zlib streams, one
    block per wave: equal to the corpus, each on the route it must take.
    streams maps a name to (stream, fallback cause): None for a stream
    the card decodes; else the cause for which the wave engine gives the
    stream up to the host's serial decoder after phase A has run on the
    card (a block longer than the largest lane, as in the reference),
    and the stream counts as a host decode."""
    from zlibng_tpu_torch import decompress_cuda
    for name, (stream, cause) in streams.items():
        r = _decode_run(lambda: decompress_cuda(stream, engine="device"))
        if r["out"] != data:
            raise AssertionError(f"single-stream decode {name}: output "
                                 f"differs from the corpus ({r['error']})")
        _device_route(f"single-stream decode {name}", r, cause)
        if cause is None:
            print(f"single-stream decode of {name} ({len(stream)} B) on the "
                  f"card: equal to the corpus; stats change {r['stats']}; "
                  + _split(r), flush=True)
            continue
        sp = r["split"]
        print(f"single-stream decode of {name} ({len(stream)} B): a HOST "
              f"decode: the card's phase A gave it up after {sp['phase_a']} "
              f"dispatches ({sp['phase_a_s']:.3f} s; cause: {cause}), then "
              f"the serial decoder took {r['s'] - sp['total_s']:.3f} s; "
              f"equal to the corpus; {r['s']:.3f} s in all; stats change "
              f"{r['stats']}", flush=True)


def _mixed_blocks(parts: list) -> bytes:
    """One raw stream of a fixed-tree, a stored and a dynamic piece (each
    piece its own compressor, joined at byte-aligned sync flushes)."""
    out = b""
    for i, (level, strategy, piece) in enumerate(parts):
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
        out += co.compress(piece) + co.flush(
            zlib.Z_FINISH if i == len(parts) - 1 else zlib.Z_SYNC_FLUSH)
    return out


def decode_options(data: bytes) -> None:
    """Framing and options on a 64 KiB prefix (the host's CRC-32 is a
    Python loop): each decode on the card equal to stdlib zlib's and to the
    CPU port's, on the device path; the host engine launches no kernel."""
    from zlibng_tpu_torch import decompress_cuda
    small = data[: 1 << 16]
    dct = data[1 << 16: (1 << 16) + 30000]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = co.compress(small) + co.flush()
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, 0, dct)
    with_dict = co.compress(small) + co.flush()
    co = zlib.compressobj(6, zlib.DEFLATED, -9)
    raw9 = co.compress(small) + co.flush()
    co = zlib.compressobj(6, zlib.DEFLATED, 9)
    z9 = co.compress(small) + co.flush()
    mixed = _mixed_blocks([(6, zlib.Z_FIXED, small[:20000]),
                           (0, 0, small[20000:40000]), (6, 0, small)])
    cases = [("gzip, wbits=31", gzip.compress(small), dict(wbits=31), small),
             ("gzip, auto wbits=47", gzip.compress(small), dict(wbits=47),
              small),
             ("zlib, auto wbits=47", zlib.compress(small), dict(wbits=47),
              small),
             ("raw, wbits=-15", raw, dict(wbits=-15), small),
             ("preset dictionary", with_dict, dict(dictionary=dct), small),
             ("raw, wbits=-9", raw9, dict(wbits=-9), small),
             ("zlib, window 512 (wbits=9)", z9, dict(wbits=9), small),
             ("fixed + stored + dynamic blocks", mixed, dict(wbits=-15),
              small[:40000] + small)]
    for name, stream, kw, want in cases:
        do = zlib.decompressobj(kw.get("wbits", 15),
                                **({"zdict": kw["dictionary"]}
                                   if "dictionary" in kw else {}))
        ref = do.decompress(stream) + do.flush()
        r = _decode_run(lambda: decompress_cuda(stream, **kw))
        if r["out"] != want or ref != want:
            raise AssertionError(f"decode {name}: differs from zlib")
        if decompress_cuda(stream, device="cpu", **kw) != r["out"]:
            raise AssertionError(f"decode {name}: differs from the CPU port")
        _device_route(f"decode {name}", r)
        print(f"decode {name}: {len(stream)} B -> {len(want)} B equal to "
              f"zlib and the CPU port; device path, waves "
              f"{r['split']['waves']}, K2 launches {r['k2']}; {r['s']:.3f} s",
              flush=True)
    r = _decode_run(lambda: decompress_cuda(zlib.compress(small),
                                            engine="host"))
    if r["out"] != small or _route(r) != "host" or r["k2"]:
        raise AssertionError(f"decode, host engine: {r['stats']}, "
                             f"K2 {r['k2']}")
    print(f"decode, host engine (64 KiB, the serial decoder's C route, "
          f"{type(r['out']).__name__}): equal; no kernel launched; "
          f"{r['s']:.3f} s", flush=True)


# corrupt streams of decode_errors: what each must raise, and the cause
# for which the card's wave engine gives it up (None: the card decodes
# the body, and the host's trailer check rejects it)
CORRUPT = {"byte 300 flipped": ("invalid distance too far back",
                                "distance before the window or dictionary"),
           "byte 1000 flipped": ("invalid distance too far back",
                                 "distance before the window or dictionary"),
           "byte -6 flipped": ("unexpected end of stream",
                               "no end-of-block before the stream's end"),
           "truncated to 100 B": ("unexpected end of stream",
                                  "no end-of-block before the stream's end"),
           "Z_FIXED, byte 20000 ^ 0x10": ("invalid distance code",
                                          "invalid code"),
           "bad adler32 trailer": ("incorrect data check", None)}


def decode_errors(data: bytes) -> None:
    """Corrupt, truncated and bad-trailer zlib streams of a 64 KiB prefix
    (CORRUPT): each must go through phase A on the card (one K2 launch per
    dispatch) and be rejected there for its cause, or decode there and
    fail the trailer check; its error text (from the serial rerun, for
    zlib's wording), route and cause equal to the CPU port's."""
    from zlibng_tpu_torch import decompress_cuda
    small = data[: 1 << 16]
    base = zlib.compress(small, 6)
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
    fixed = co.compress(small) + co.flush()

    def flip(buf: bytes, at: int, mask: int = 0xFF) -> bytes:
        c = bytearray(buf)
        c[at] ^= mask
        return bytes(c)

    cases = {"byte 300 flipped": flip(base, 300),
             "byte 1000 flipped": flip(base, 1000),
             "byte -6 flipped": flip(base, len(base) - 6),
             "truncated to 100 B": base[:100],
             "Z_FIXED, byte 20000 ^ 0x10": flip(fixed, 20000, 0x10),
             "bad adler32 trailer": flip(base, len(base) - 1)}
    for name, c in cases.items():
        text, cause = CORRUPT[name]
        card = _decode_run(lambda: decompress_cuda(c))
        cpu = _decode_run(lambda: decompress_cuda(c, device="cpu"))
        _device_route(f"corrupt stream {name}", card, cause)
        if (card["error"], cpu["error"]) != (text, text) \
                or (card["stats"], card["split"]["fallback_cause"],
                    card["k2"]) != (cpu["stats"],
                                    cpu["split"]["fallback_cause"],
                                    cpu["split"]["phase_a"]):
            raise AssertionError(f"corrupt stream {name}: card "
                                 f"{card['error']!r} {card['stats']} K2 "
                                 f"{card['k2']}, CPU "
                                 f"{cpu['error']!r} {cpu['stats']}, want "
                                 f"{text!r}")
        print(f"corrupt stream, {name}: card and CPU port raise {text!r}; "
              f"the card's wave engine ran {card['k2']} phase A dispatch(es)"
              f" and " + (f"gave the stream up ({cause})" if cause else
                          "decoded it, the host's trailer check failed"),
              flush=True)


def checksums(data: bytes) -> None:
    """adler32_cuda and crc32_cuda of the corpus against zlib's, seeded
    and not; cold call and median of 5 warm calls (host clock, upload and
    result fetch included), beside zlib's time on the host."""
    from zlibng_tpu_torch.ops.checksum import adler32_cuda, crc32_cuda
    for name, fn, ref in (("adler32", adler32_cuda, zlib.adler32),
                          ("crc32", crc32_cuda, zlib.crc32)):
        t0 = time.perf_counter()
        got = fn(data)
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(data)
            warm.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = ref(data)
        host = time.perf_counter() - t0
        if got != want or fn(data, 0x12345678) != ref(data, 0x12345678):
            raise AssertionError(f"{name}_cuda: {got:#x} != zlib {want:#x}")
        print(f"{name}_cuda of {len(data)} B: {got:#010x}, equal to zlib "
              f"(also seeded); cold {cold * 1e3:.2f} ms, warm "
              f"{statistics.median(warm) * 1e3:.2f} ms; zlib on the host "
              f"{host * 1e3:.2f} ms", flush=True)


def native_runtime(data: bytes, l6_stream: bytes) -> bytes:
    """The host runtime (native/zng_host.c) on the whole corpus: gzip
    framing of compress_cuda (its CRC-32 in C), the decode of that stream
    (over 1 MiB: the host engine, the C serial decoder and CRC-32) against
    zlib, and, timed, the host CRC-32 and the serial decoder on the port's
    L6 stream (the stream the card's phase A gives up), each on its C and
    its numpy route (the numpy CRC-32 on a 1 MiB prefix only). Returns the
    gzip stream, compress_cuda(data, 6, wbits=31)."""
    from zlibng_tpu_torch import compress_cuda, decompress_cuda, native
    from zlibng_tpu_torch.checksum.crc32 import crc32
    from zlibng_tpu_torch.stream import inflate_serial
    if not native.available():
        raise AssertionError("native host runtime did not build")
    t0 = time.perf_counter()
    gz = compress_cuda(data, 6, wbits=31)
    torch.cuda.synchronize()
    gz_s = time.perf_counter() - t0
    if zlib.decompress(gz, 31) != data or gzip.decompress(gz) != data:
        raise AssertionError("gzip framing: stdlib round trip failed")
    if gz[10:-8] != l6_stream[2:-4]:
        raise AssertionError("gzip framing: payload differs from the zlib "
                             "stream's at L6")
    t0 = time.perf_counter()
    out = decompress_cuda(gz, wbits=31)
    dec_s = time.perf_counter() - t0
    if out != data:
        raise AssertionError("gzip decode: output differs from the corpus")
    print(f"native: gzip compress_cuda(wbits=31) of {len(data)} B -> "
          f"{len(gz)} B in {gz_s:.3f} s (cold) = "
          f"{len(data) / gz_s / 1e6:.3f} MB/s, payload equal to the L6 zlib "
          f"stream's; zlib and gzip round trips ok; decompress_cuda(wbits=31)"
          f" (host engine, {type(out).__name__}) {dec_s:.3f} s = "
          f"{len(data) / dec_s / 1e6:.3f} MB/s, equal", flush=True)

    def best(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            got = fn()
            times.append(time.perf_counter() - t0)
        return got, min(times), statistics.median(times)

    crc, c_min, c_med = best(lambda: crc32(data), 5)
    if crc != zlib.crc32(data):
        raise AssertionError("native crc32 differs from zlib")
    prefix = data[: 1 << 20]
    lib = native._lib
    native._lib = False
    try:
        crc_np, n_min, _ = best(lambda: crc32(prefix), 1)
    finally:
        native._lib = lib
    if crc_np != zlib.crc32(prefix):
        raise AssertionError("numpy crc32 differs from zlib")
    print(f"native: host crc32 of {len(data)} B in C {c_min * 1e3:.2f} ms "
          f"(median {c_med * 1e3:.2f} ms of 5) = "
          f"{len(data) / c_min / 1e6:.1f} MB/s; numpy route {n_min:.3f} s "
          f"for 1 MiB = {len(prefix) / n_min / 1e6:.3f} MB/s", flush=True)
    raw = l6_stream[2:-4]
    (o_c, _), s_min, s_med = best(lambda: inflate_serial.inflate_raw(raw), 3)
    inflate_serial._native_lib = False
    try:
        (o_np, _), p_min, _ = best(lambda: inflate_serial.inflate_raw(raw), 1)
    finally:
        inflate_serial._native_lib = None
    if o_c != data or o_np != data or type(o_c) is not memoryview:
        raise AssertionError("serial decoder: routes differ from the corpus")
    print(f"native: serial decoder on the port's L6 stream ({len(raw)} B "
          f"raw): C route {s_min:.3f} s (median {s_med:.3f} s of 3) = "
          f"{len(data) / s_min / 1e6:.1f} MB/s out, a memoryview; numpy "
          f"route {p_min:.3f} s = {len(data) / p_min / 1e6:.3f} MB/s; both "
          f"equal to the corpus", flush=True)
    return gz


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def _counted(fn) -> tuple:
    """fn() with the K1 and K2 wrappers' counts set to 0 just before and
    read just after: (result, seconds, {"K1": n, "K2": n})."""
    from zlibng_tpu_torch.ops import parse, probe
    _reset_launches("probe", "parse")
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return out, sec, {"K1": probe.launches, "K2": parse.launches}


def _minigzip_t(data: bytes, level: int, want: bytes, main_launches: dict,
                tmp: Path) -> None:
    """minigzip -t -LEVEL -k of the corpus, in-process through
    cli.minigzip.main (K1 and K2 counted: as many launches as the main
    path's call at that level) and once more as `python -m
    zlibng_tpu_torch.cli.minigzip` in a subprocess; both .gz files equal
    compress_cuda(data, level, wbits=31), and decode to the corpus through
    the port's minigzip -d (GzFile, Inflate, the C serial decoder; no
    kernel launched) and through Python's gzip module."""
    from zlibng_tpu_torch.cli import minigzip
    src = tmp / f"corpus-L{level}.bin"
    src.write_bytes(data)
    gz_path = Path(f"{src}.gz")
    rc, sec, launches = _counted(lambda: minigzip.main(
        ["-t", f"-{level}", "-k", str(src)]))
    name = f"public surface: minigzip -t -{level}"
    if rc != 0 or gz_path.read_bytes() != want:
        raise AssertionError(f"{name}: the .gz differs from "
                             f"compress_cuda(data, {level}, wbits=31)")
    if launches != main_launches or not all(launches.values()):
        raise AssertionError(f"{name}: launches {launches}, the main path's "
                             f"call {main_launches}")
    print(f"{name} -k (in-process, cli.minigzip.main): {len(data)} B -> "
          f"{len(want)} B in {sec:.3f} s = {len(data) / sec / 1e6:.3f} "
          f"MB/s; equal to compress_cuda(data, {level}, wbits=31)",
          flush=True)
    print(f"{name} launches: K1 {launches['K1']}, K2 {launches['K2']} "
          f"(the main path's call: {main_launches})", flush=True)
    sub_src = tmp / f"corpus-L{level}-sub.bin"
    sub_src.write_bytes(data)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "zlibng_tpu_torch.cli.minigzip",
                        "-t", f"-{level}", "-k", str(sub_src)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"{name} in a subprocess: rc {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    if Path(f"{sub_src}.gz").read_bytes() != want:
        raise AssertionError(f"{name} in a subprocess: the .gz differs")
    print(f"{name} -k (python -m zlibng_tpu_torch.cli.minigzip, a new "
          f"process: start, kernel load, a cold call): {sub_s:.3f} s = "
          f"{len(data) / sub_s / 1e6:.3f} MB/s; the .gz equal", flush=True)
    src.unlink()
    rc, dec_s, dec_launches = _counted(lambda: minigzip.main(
        ["-d", str(gz_path)]))
    if rc != 0 or src.read_bytes() != data or gz_path.exists():
        raise AssertionError(f"{name}: minigzip -d did not give the corpus")
    if any(dec_launches.values()):
        raise AssertionError(f"{name}: minigzip -d launched {dec_launches}")
    if gzip.decompress(want) != data:
        raise AssertionError(f"{name}: Python's gzip module disagrees")
    print(f"{name}: minigzip -d (host: GzFile, Inflate, C serial decoder) "
          f"{dec_s:.3f} s = {len(data) / dec_s / 1e6:.3f} MB/s out, equal "
          f"to the corpus, no kernel launched; Python's gzip module agrees",
          flush=True)


def _host_round_trips(data: bytes, tmp: Path) -> None:
    """The host surface on a prefix, against stdlib zlib and gzip: pyzlib
    one-shot and compressobj/decompressobj (chunked, Z_SYNC_FLUSH),
    zng_compress2/zng_uncompress2, gzopen write then read, and Deflate
    with Z_FULL_FLUSH resynced by Inflate.sync() past a damaged segment.
    Every call runs on the host: no kernel may launch."""
    from zlibng_tpu_torch import Deflate, Inflate, Z_FINISH, Z_FULL_FLUSH
    from zlibng_tpu_torch import gzopen, pyzlib, zng
    from zlibng_tpu_torch.errors import DataError
    step = len(data) // 4

    def trips() -> list:
        done = []
        if zlib.decompress(pyzlib.compress(data, 6)) != data or \
                pyzlib.decompress(zlib.compress(data, 6)) != data:
            raise AssertionError("pyzlib one-shot round trip failed")
        done.append("pyzlib.compress/decompress")
        co, std = pyzlib.compressobj(6), zlib.decompressobj()
        do, src = pyzlib.decompressobj(), zlib.compress(data, 9)
        for i in range(0, len(data), step):
            piece = co.compress(data[i:i + step]) + co.flush(
                pyzlib.Z_SYNC_FLUSH)
            if std.decompress(piece) != data[i:i + step]:
                raise AssertionError("pyzlib.compressobj: a sync-flushed "
                                     "chunk did not decode with zlib")
        back = b"".join(do.decompress(src[i:i + 4096])
                        for i in range(0, len(src), 4096)) + do.flush()
        if back != data or not do.eof:
            raise AssertionError("pyzlib.decompressobj: chunked decode")
        done.append("compressobj (chunks, Z_SYNC_FLUSH)/decompressobj")
        c2 = zng.zng_compress2(data, 6)
        if zlib.decompress(c2) != data or \
                zng.zng_uncompress2(c2 + b"tail") != (data, len(c2)):
            raise AssertionError("zng_compress2/zng_uncompress2")
        done.append("zng_compress2/zng_uncompress2")
        path = str(tmp / "surface.gz")
        with gzopen(path, "wb") as f:
            f.write(data)
        with gzopen(path, "rb") as f:
            back = f.read()
        if back != data or gzip.decompress(Path(path).read_bytes()) != data:
            raise AssertionError("gzopen write/read")
        done.append("gzopen write/read")
        d = Deflate(level=6, wbits=-15)
        segs = [d.compress(data[i:i + step], Z_FULL_FLUSH
                           if i + step < len(data) else Z_FINISH)
                for i in range(0, len(data), step)]
        if zlib.decompress(b"".join(segs), -15) != data:
            raise AssertionError("Deflate Z_FULL_FLUSH: zlib round trip")
        inf = Inflate(wbits=-15)
        try:                     # block type 3 (invalid) in segment 0
            inf.decompress(b"\xff" + segs[0][1:])
        except DataError:
            pass
        else:
            raise AssertionError("Inflate took a damaged segment")
        if not inf.sync() or inf.decompress(b"".join(segs[1:]),
                                            finish=True)[-3 * step:] \
                != data[step:]:
            raise AssertionError("Inflate.sync() past a damaged segment")
        done.append("Deflate Z_FULL_FLUSH + Inflate.sync()")
        return done

    done, sec, launches = _counted(trips)
    if any(launches.values()):
        raise AssertionError(f"host surface launched kernels {launches}")
    print(f"public surface: host round trips on {len(data)} B, equal to "
          f"stdlib zlib/gzip: {'; '.join(done)}; {sec:.3f} s", flush=True)
    print(f"public surface host round trips launches: K1 {launches['K1']}, "
          f"K2 {launches['K2']}", flush=True)


def public_surface(data: bytes, gz6: bytes, runs: dict) -> None:
    """The public surface on the card where the reference's reaches the
    TPU: minigzip -t at L6 and L1 (compress_cuda; K1 and K2 counted), and
    decompress_indexed_cuda of compress_indexed's blob (the host Deflate
    with full flushes; its digest pinned to the reference's, INDEXED_STREAM)
    on the device route; then the host surface's round trips, which launch
    no kernel."""
    from zlibng_tpu_torch import compress_cuda
    from zlibng_tpu_torch.parallel.index import (
        compress_indexed, decompress_indexed_cuda,
    )
    print(f"public surface on {card()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        gz1 = compress_cuda(data, 1, wbits=31)
        if gz1[10:-8] != runs[1, 0]["stream"][2:-4]:
            raise AssertionError("gzip framing: payload differs from the "
                                 "zlib stream's at L1")
        for level, want in ((6, gz6), (1, gz1)):
            _minigzip_t(data, level, want, runs[level, 0]["launches"], tmp)
        prefix = data[:INDEXED_PREFIX]
        t0 = time.perf_counter()
        blob, idx = compress_indexed(prefix, level=6,
                                     segment=INDEXED_SEGMENT)
        comp_s = time.perf_counter() - t0
        digest = (len(blob), hashlib.sha256(blob).hexdigest()[:16])
        if digest != INDEXED_STREAM:
            raise AssertionError(f"compress_indexed: {digest}, the "
                                 f"reference's {INDEXED_STREAM}")
        print(f"public surface: compress_indexed of {len(prefix)} B (L6, "
              f"{len(idx.comp_offsets) - 1} segments of {INDEXED_SEGMENT} B,"
              f" host Deflate) -> {len(blob)} B (sha256 {digest[1]}, equal "
              f"to the reference's) in {comp_s:.3f} s = "
              f"{len(prefix) / comp_s / 1e6:.3f} MB/s (the card box's CPU)",
              flush=True)
        r = _decode_run(lambda: decompress_indexed_cuda(blob, idx))
        if r["out"] != prefix:
            raise AssertionError(f"decompress_indexed_cuda of "
                                 f"compress_indexed's blob ({r['error']})")
        _device_route("public surface indexed decode", r)
        print(f"public surface: decompress_indexed_cuda of compress_indexed's "
              f"blob: equal to the prefix, device route; stats change "
              f"{r['stats']}; " + _split(r), flush=True)
        print(f"public surface indexed decode launches: K1 0, K2 {r['k2']} "
              f"(phase A dispatches {r['split']['phase_a']})", flush=True)
        _host_round_trips(data[:HOST_SURFACE_BYTES], tmp)


SHARD_LANE_BLOCK = 1 << 16
# the card every shard of the sharded phases runs on
CARD = "cuda:0"
# shard counts of the sharded phases: one shard, and eight on one card
SHARD_COUNTS = (1, 8)
# the sharded decode's corrupt blob: the indexed blob with byte 20 of
# segment 1 xored with 0x55, and the error the reference's
# decompress_segments_multichip raises for it (test_torch_sharded.py
# recomputes it)
SHARDED_CORRUPT = (1, 20, "invalid literal/lengths set")


def sharded_compress(data: bytes, rows: list) -> dict:
    """compress_multichip on the whole corpus at lane_block 65,536 (136
    lanes) with every shard on the card: one shard, and 8 shards on
    cuda:0. Each: K1 and K2 launched (wrapper counts), zlib round trip,
    cold and warm seconds, equal to the port's CPU run with as many shards
    on the 1 MiB prefix, and a profile of the prefix whose K1 and K2
    kernels equal the wrapper counts. The 8-shard run keeps one shard's K1
    and K2 inputs for the kernel checks (`rows`)."""
    from zlibng_tpu_torch.ops import parse, probe
    from zlibng_tpu_torch.parallel.sharded import compress_multichip
    lb = SHARD_LANE_BLOCK
    prefix = data[: 1 << 20]
    out = {}
    for k in SHARD_COUNTS:
        devs = [CARD] * k
        kept = {}
        k1, k2 = probe._probe_best_cuda, parse._parse_select_cuda

        def keep1(*a, **kw):
            kept.setdefault("K1", a)
            return k1(*a, **kw)

        def keep2(*a):
            kept.setdefault("K2", a)
            return k2(*a)

        _reset_launches("probe", "parse")
        probe._probe_best_cuda, parse._parse_select_cuda = keep1, keep2
        try:
            t0 = time.perf_counter()
            z = compress_multichip(data, devs, lane_block=lb)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
        finally:
            probe._probe_best_cuda, parse._parse_select_cuda = k1, k2
        launches = {"K1": probe.launches, "K2": parse.launches}
        if launches["K1"] == 0 or launches["K2"] == 0:
            raise AssertionError(f"sharded x{k}: missed a kernel {launches}")
        if zlib.decompress(z) != data:
            raise AssertionError(f"sharded x{k}: zlib round trip failed")
        t0 = time.perf_counter()
        if compress_multichip(data, devs, lane_block=lb) != z:
            raise AssertionError(f"sharded x{k}: warm run differs")
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        card = compress_multichip(prefix, devs, lane_block=lb)
        t0 = time.perf_counter()
        cpu = compress_multichip(prefix, ["cpu"] * k, lane_block=lb)
        cpu_s = time.perf_counter() - t0
        if card != cpu:
            raise AssertionError(f"sharded x{k}: 1 MiB prefix differs from "
                                 "the CPU port")
        _reset_launches("probe", "parse")
        dev, _, wall = _kernels(lambda: compress_multichip(prefix, devs,
                                                           lane_block=lb))
        counted = {"K1": probe.launches // 2, "K2": parse.launches // 2}
        seen = {"K1": sum("probe_walk" in e.name for e in dev),
                "K2": sum("parse_stitch" in e.name for e in dev)}
        if not dev:
            raise AssertionError(f"sharded x{k}: the profiler recorded no "
                                 "device events")
        if seen["K1"] == 0 or seen["K2"] == 0 or seen != counted:
            raise AssertionError(f"sharded x{k}: profiler saw {seen}, "
                                 f"wrappers counted {counted}")
        nl = -(-len(data) // lb)
        print(f"sharded compress x{k} shard(s) on {CARD}, lane_block {lb} "
              f"({nl} lanes, {-(-nl // k)} per shard): {len(data)} B -> "
              f"{len(z)} B (ratio {len(z) / len(data):.4f}, sha256 "
              f"{hashlib.sha256(z).hexdigest()[:16]}); zlib round trip ok; "
              f"launches {launches}; cold {cold:.3f} s, warm {warm:.3f} s = "
              f"{len(data) / warm / 1e6:.3f} MB/s; 1 MiB prefix equal to the "
              f"CPU port's x{k} ({cpu_s:.1f} s on the host); profiled prefix"
              f": {seen['K1']} probe_walk and {seen['K2']} parse stitch "
              f"kernels = the wrapper counts, wall {wall:.3f} s",
              flush=True)
        out[k] = dict(stream=z, launches=launches, warm_s=warm, kept=kept)
    kept = out[SHARD_COUNTS[-1]].pop("kept")
    k = SHARD_COUNTS[-1]
    a = kept["K1"][:11]
    got = probe._probe_best_cuda(*a)
    want = probe._probe_plain(*a)
    err = max(int((g.long() - w.long()).abs().max()) for g, w in
              zip(got, want))
    if err:
        raise AssertionError(f"K1 sharded inputs: kernel != plain ({err})")
    B, N, W = a[0].shape
    ms = timed(lambda: probe._probe_best_cuda(*a), 20)
    plain_ms = timed(lambda: probe._probe_plain(*a), 3)
    b_ms, by = bound(_k1_bytes(B, N, W, a[8] > a[4]), 0)
    print(f"K1 probe_best on one shard's inputs (x{k}) B={B} N={N} W={W} "
          f"dense {a[4]}: equal to plain; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, byte bound {b_ms:.4f} ms", flush=True)
    rows.append(dict(name=f"K1 probe_best (sharded compress, {k} shards, "
                     f"{B} lanes each)", kernel="K1", max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                     launches=out[k]["launches"]["K1"]))
    step, bounds = kept["K2"]
    row = _k2_case(f"sharded compress fused steps ({k} shards)", step,
                   bounds)
    rows.append(dict(row, name=f"K2 parse_select (sharded compress, {k} "
                     f"shards, {step.shape[0]} lanes each)", kernel="K2",
                     launches=out[k]["launches"]["K2"]))
    return out


def sharded_decode(indexed: dict, rows: list) -> None:
    """decompress_segments_multichip of the indexed blob (9 segments) with
    one shard and 8 shards on cuda:0: equal to decompress_segments_cuda's
    output, on the sharded path (stats mesh_ok, no fallback), K2 launched;
    then the corrupt blob of SHARDED_CORRUPT raises the reference's text
    and counts stats["error"]."""
    from zlibng_tpu_torch.errors import DataError
    from zlibng_tpu_torch.ops import inflate, parse
    from zlibng_tpu_torch.ops.inflate import decompress_segments_cuda
    from zlibng_tpu_torch.parallel.sharded import (
        decompress_segments_multichip,
    )
    blob = indexed["blob"]
    starts = indexed["idx"].comp_offsets[:-1]
    want = decompress_segments_cuda(blob, starts)
    k2, kept = parse._parse_select_cuda, []

    def keep(*a):
        if not kept:
            kept.append(a)
        return k2(*a)

    for k in SHARD_COUNTS:
        devs = [CARD] * k
        parse._parse_select_cuda = keep if k == SHARD_COUNTS[-1] else k2
        try:
            r = _decode_run(lambda: decompress_segments_multichip(
                blob, starts, devs))
        finally:
            parse._parse_select_cuda = k2
        launches = r["k2"]
        if r["out"] != want:
            raise AssertionError(f"sharded decode x{k}: output differs from "
                                 f"decompress_segments_cuda's ({r['error']})")
        if r["stats"]["mesh_ok"] != 1 or r["stats"]["fallback"] or \
                r["k2"] == 0 or r["k2"] < r["split"]["phase_a"]:
            raise AssertionError(f"sharded decode x{k}: stats {r['stats']}, "
                                 f"K2 {r['k2']}")
        print(f"sharded decode x{k} shard(s) on {CARD}: {len(starts)} "
              f"segments, equal to decompress_segments_cuda; stats change "
              f"{r['stats']}; waves {r['split']['waves']}, phase A dispatches"
              f" {r['split']['phase_a']}, K2 launches {r['k2']}; "
              f"{r['s']:.3f} s = {len(b''.join(r['out'])) / r['s'] / 1e6:.3f}"
              f" MB/s out", flush=True)
    seg, at, text = SHARDED_CORRUPT
    c = bytearray(blob)
    c[starts[seg] + at] ^= 0x55
    r = _decode_run(lambda: decompress_segments_multichip(
        bytes(c), starts, [CARD] * SHARD_COUNTS[-1]))
    if r["error"] != text or r["stats"]["error"] != 1 \
            or r["stats"]["mesh_ok"]:
        raise AssertionError(f"sharded decode, corrupt: {r['error']!r} "
                             f"{r['stats']}, want {text!r}")
    print(f"sharded decode, segment {seg} byte {at} ^ 0x55: raises {text!r}"
          f" as the reference does; stats change {r['stats']}", flush=True)
    step, bounds = kept[0]
    row = _k2_case(f"sharded decode bit-steps ({SHARD_COUNTS[-1]} shards)",
                   step, bounds)
    rows.append(dict(row, name=f"K2 parse_select (sharded decode, "
                     f"{SHARD_COUNTS[-1]} shards, {step.shape[0]} lanes "
                     f"each)", kernel="K2", launches=launches))


def multihost_one_rank(data: bytes, one_shard: bytes, indexed: dict) -> None:
    """parallel.multihost over torch.distributed with NCCL, in this process
    as rank 0 of a world of 1 over tcp://127.0.0.1 (the box has one card,
    so more ranks are checked on the CPU only, by
    tests/test_torch_multihost.py): the stream must equal the one-shard
    sharded stream, and the segments decompress_segments_cuda's."""
    import socket
    import torch.distributed as dist
    from zlibng_tpu_torch.ops.inflate import decompress_segments_cuda
    from zlibng_tpu_torch.parallel.multihost import (
        multihost_compress, multihost_decompress_segments,
    )
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        z = multihost_compress(data, lane_block=SHARD_LANE_BLOCK)
        sec = time.perf_counter() - t0
        blob = indexed["blob"]
        starts = indexed["idx"].comp_offsets[:-1]
        outs = multihost_decompress_segments(blob, starts)
    finally:
        dist.destroy_process_group()
    if z != one_shard:
        raise AssertionError("multihost: stream differs from the one-shard "
                             "sharded stream")
    if outs != decompress_segments_cuda(blob, starts):
        raise AssertionError("multihost: segments differ")
    print(f"multihost (NCCL over tcp://127.0.0.1, checked at world size 1 "
          f"only: one card on this box): stream equal to the one-shard "
          f"sharded stream, {sec:.3f} s; {len(starts)} segments equal to "
          f"decompress_segments_cuda's", flush=True)


def _kernels(fn) -> tuple[list, list, float]:
    """Device events and host events of one warm call of fn under
    torch.profiler, and the call's wall seconds (profiled)."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                              # warm
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    evs = p.events()
    return ([e for e in evs if e.device_type == cuda],
            [e for e in evs if e.device_type != cuda], wall)


def _is_launch(e) -> bool:
    """A host-side CUDA runtime call that puts one device event on the
    stream: a kernel launch, a copy or a fill."""
    return e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaMemcpy", "cudaMemset"))


def profile_group(data: bytes, level: int = 6, strategy: int = 0) -> None:
    """One lane group (2 MiB) of the main path under torch.profiler, twice:
    device events (kernels, copies, fills), summed device time and the
    device's idle share of the call's wall time. Stage 1 runs inside a
    `record_function` range, and its share is the host's launch calls
    that fall inside that range, counted in the same session."""
    from torch.profiler import record_function
    from zlibng_tpu_torch import compress_cuda
    from zlibng_tpu_torch.ops import deflate
    group = data[: 2 << 20]
    stage1 = deflate._stage1
    label = "chip_smoke stage1"

    def ranged(*a, **k):
        with record_function(label):
            return stage1(*a, **k)

    deflate._stage1 = ranged
    try:
        for session in (1, 2):
            dev, host, wall = _kernels(
                lambda: compress_cuda(group, level, strategy=strategy))
            # the range also shows on the device's timeline: not work
            dev = [e for e in dev if e.name != label]
            if not dev:
                print("profile: the profiler saw no device events (not "
                      "measured)", flush=True)
                return
            spans = [e.time_range for e in host if e.name == label]
            launches = [e for e in host if _is_launch(e)]
            in_s1 = sum(any(r.start <= e.time_range.start < r.end
                            for r in spans) for e in launches)
            mem = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
            busy = sum(e.device_time for e in dev) / 1e6     # us -> s
            by_name: dict[str, float] = {}
            for e in dev:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
            top = sorted(((t, n) for n, t in by_name.items()),
                         reverse=True)[:5]
            print(f"profile {_name(level, strategy)} one 2 MiB group, "
                  f"session {session}: wall {wall:.3f} s (profiled), "
                  f"{len(dev)} device events ({len(dev) - mem} kernels, "
                  f"{mem} copies and fills); {len(launches)} host launch "
                  f"calls, {in_s1} of them in stage 1's {len(spans)} "
                  f"range(s), {len(launches) - in_s1} after; device time "
                  f"{busy:.4f} s, device idle share {1 - busy / wall:.4f}; "
                  f"top by device time: " + "; ".join(
                      f"{n[:60]} {t / 1e3:.2f} ms" for t, n in top),
                  flush=True)
    finally:
        deflate._stage1 = stage1


def profile_decode(indexed: dict) -> None:
    """One warm indexed decode of the corpus under torch.profiler: device
    events, kernel time, the device's idle share of the call's wall time,
    and the top kernels by device time."""
    from zlibng_tpu_torch.parallel.index import decompress_indexed_cuda
    dev, host, wall = _kernels(lambda: decompress_indexed_cuda(
        indexed["blob"], indexed["idx"]))
    if not dev:
        print("profile indexed decode: the profiler saw no device events "
              "(not measured)", flush=True)
        return
    mem = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
    busy = sum(e.device_time for e in dev) / 1e6
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    top = sorted(((t, n) for n, t in by_name.items()), reverse=True)[:6]
    print(f"profile indexed decode: wall {wall:.3f} s (profiled), "
          f"{len(dev)} device events ({len(dev) - mem} kernels, {mem} copies "
          f"and fills), {sum(_is_launch(e) for e in host)} host launch "
          f"calls; device time {busy:.4f} s, device idle share "
          f"{1 - busy / wall:.4f}; top by device time: " + "; ".join(
              f"{n[:60]} {t / 1e3:.2f} ms" for t, n in top), flush=True)


def profile_k1(rows: list, deep: dict) -> None:
    """torch.profiler over K1's operating points (device ms per call, and
    the kernels one call launches: the walk alone, also at chain 128) and
    over one call of the plain deep probes (its kernels and device time).
    Sets `device_ms` in the rows: K1's device time per call, or None where
    the profiler saw nothing."""
    for row in rows:
        kern, _, _ = _kernels(row["run"])
        names = sorted({e.name.split("::")[-1].split("(")[0] for e in kern})
        if kern and (len(kern) != 1 or "probe_walk" not in kern[0].name):
            raise AssertionError(f"K1 {row['name']}: one call launched "
                                 f"{len(kern)} kernels {names}, not the walk "
                                 "alone")
        dev = device_ms(row["run"], 20, "probe_walk")
        row["device_ms"] = sum(dev.values()) if dev else None
        print(f"K1 {row['name']}: " + (
            f"device {row['device_ms']:.4f} ms per call, one kernel per call "
            f"({names[0]})" if dev and kern else "device time not measured"),
            flush=True)
    kern, _, _ = _kernels(deep["run"])
    if not kern:
        print("plain deep probes: device time not measured", flush=True)
        return
    print(f"plain deep probes: {len(kern)} CUDA kernels per call "
          f"({deep['chunks']} chunks), device "
          f"{sum(e.device_time for e in kern) / 1e3:.4f} ms per call",
          flush=True)


def phase(name: str, fn, *args):
    """Run one phase of the smoke and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from zlibng_tpu_torch import _build

    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    took = _build.build()
    each = ", ".join(f"{k} {v:.2f} s" for k, v in took.items())
    print(f"phase build: {time.perf_counter() - t0:.2f} s ({each or 'cached'})",
          flush=True)
    from zlibng_tpu_torch import native
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host runtime (native/zng_host.c) "
                             "did not build")
    print(f"phase build native host runtime: {time.perf_counter() - t0:.2f}"
          f" s ({native.library_path().name})", flush=True)
    for name in _build.KERNELS:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            print(f"ptxas {name}: " + " | ".join(
                ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln), flush=True)

    data, parts = corpus()
    print(f"corpus {len(data)} B, seed {SEED}, sha256 "
          f"{hashlib.sha256(data).hexdigest()[:16]}: " + "; ".join(
              f"{k} {n} B" for k, n in parts), flush=True)

    # the timed main paths first, so that no earlier phase (allocations,
    # profiler sessions) can skew their end-to-end numbers
    runs = {}
    for lv, st in ((6, 0), (9, 0), (1, 0), (6, 4)):
        runs[lv, st] = phase(f"main path {_name(lv, st)}", main_path, data,
                             lv, st)
    deep_launches = phase("deep probes", deep_path, data)
    phase("host route", host_route, data)
    # decode: the indexed path at full size first, then single streams,
    # options, errors and the device checksums
    indexed = phase("indexed decode", indexed_decode, data)
    phase("single-stream decode", single_decode, data, {
        "the port's L6 stream": (runs[6, 0]["stream"],
                                 "block larger than the largest lane"),
        "the port's L1 stream": (runs[1, 0]["stream"], None),
        "stdlib zlib's L6 stream": (zlib.compress(data, 6), None)})
    phase("decode framing and options", decode_options, data)
    phase("decode errors", decode_errors, data)
    phase("device checksums", checksums, data)
    gz6 = phase("native host runtime", native_runtime, data,
                runs[6, 0]["stream"])
    phase("public surface", public_surface, data, gz6, runs)
    shard_rows = []
    sharded = phase("sharded compress", sharded_compress, data, shard_rows)
    phase("sharded decode", sharded_decode, indexed, shard_rows)
    phase("multihost, world size 1", multihost_one_rank, data,
          sharded[1]["stream"], indexed)

    dev = torch.device("cuda")
    lanes = first_group_lanes(data, dev)
    k1, k2 = [], []
    k1_inputs = phase("K1 check", check_k1, lanes, k1)
    phase("K1 adversarial lanes", check_k1_walk)
    k2_cases = phase("K2 check", check_k2, lanes, k2)
    k2_cases.append(phase("K2 decode check", check_k2_decode,
                          indexed.pop("wave"), k2, indexed["launches"]))
    deep = phase("deep-probe timing", time_deep_probes, k1_inputs)
    huf_rows = phase("Huffman kernel check", check_huffman, data)
    lut_rows = phase("flat LUT kernel check", check_flat_luts,
                     dict(indexed, data=data))
    check_estimate(lanes)
    del lanes, k1_inputs
    t0 = time.perf_counter()
    profile_k2(k2_cases, k2)
    del k2_cases
    profile_k1(k1, deep)
    del deep
    for lv, st in ((6, 0), (1, 0), (6, 4)):
        profile_group(data, lv, st)
    profile_decode(indexed)
    print(f"phase profile: {time.perf_counter() - t0:.1f} s", flush=True)

    src = "zlibng_tpu_torch/csrc/"
    kernels = []
    for row in k1:
        lv = row["level"]
        kernels.append(dict(
            name=f"K1 probe_best ({row['name']})", route="cuda",
            source=src + "probe.cu",
            replaces="zlibng_tpu/ops/probe_pallas.py:51",
            launches=(runs[lv, 0]["launches"]["K1"] if lv
                      else deep_launches["K1"]),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            device_ms=row.get("device_ms"),
            plain_probes=row["plain_probes"], walk_bound=row["walk_bound"]))
    for row in k2:
        lv = row.get("level")
        kernels.append(dict(
            name=(f"K2 parse_select (fused steps, L{lv})" if lv else
                  f"K2 parse_select ({row['name']})"), route="cuda",
            source=src + "parse.cu",
            replaces="zlibng_tpu/ops/parse_pallas.py:26",
            launches=(runs[lv, 0]["launches"]["K2"] if lv
                      else row["launches"]),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            device_ms=row.get("device_ms")))
    for row in shard_rows:
        k1 = row["kernel"] == "K1"
        kernels.append(dict(
            name=row["name"], route="cuda",
            source=src + ("probe.cu" if k1 else "parse.cu"),
            replaces=("zlibng_tpu/ops/probe_pallas.py:51" if k1 else
                      "zlibng_tpu/ops/parse_pallas.py:26"),
            launches=row["launches"], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None))
    for row in huf_rows:
        kernels.append(dict(
            name=f"huff_build (G = {row['G']})", route="cuda",
            source=src + "huffman.cu", replaces=None,
            launches=runs[6, 0]["huffman_launches"],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            device_ms=row["device_ms"]))
    for row in lut_rows:
        kernels.append(dict(
            name=f"flat_luts ({row['name']}, B = {row['B']}, lut_cap = "
                 f"{row['lut_cap']})", route="cuda",
            source=src + "flat_luts.cu", replaces=None,
            launches=row["launches"], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            device_ms=row["device_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke total: {time.perf_counter() - t_all:.1f} s",
          flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
