#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (zlibng_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from zlibng_tpu_torch/csrc with nvcc, then drives
the main path first, compress_cuda at levels 6 and 9 on a seeded corpus of
at least 8 MiB, and checks that zlib decodes it, that it equals the port's
CPU output (on a 1 MiB prefix and on the whole corpus) and that the run
went through both kernels. Then it holds each kernel (K1 probe sweep, K2
parse walk) against its plain PyTorch version at the main path's shapes
(K2 also on raw steps, on step arrays that defeat its speculation or test
its step arithmetic, and on edge bounds), and last runs torch.profiler:
K2's device time by phase and one lane group of the main path. Prints
per-kernel timings, a `kernels` JSON line, the
card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Exits non-zero, without that line, when
any phase fails or no CUDA device is present. Imports nothing of JAX.
"""
from __future__ import annotations

import gzip
import hashlib
import json
import statistics
import subprocess
import sys
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
# int32 operations of one (row, k) probe in K1: 4 xors, 4 byte-ctz (test,
# ffs, shift), 3 selects, hash compare, distance, 3 range tests, score,
# best compare/update (the count csrc/probe.cu's note works from)
PROBE_OPS = 32
# operations of one K2 stop: store, load, max, add, compare
PARSE_OPS = 5


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


def check_k1(lanes: torch.Tensor, rows: list) -> None:
    from zlibng_tpu_torch.ops import lz77, probe
    B, N = lanes.shape
    pad = torch.cat([lanes, lanes.new_zeros((B, 16))], 1)
    w2_s, h_s, pos_s, _ = lz77.sorted_probe_rows(lz77._build_w4(pad), N)
    hv = torch.zeros(B, dtype=torch.int32, device=lanes.device)
    hv[0] = 32768
    W = w2_s.shape[2]
    for dense in (16, 64):
        args = (w2_s, h_s, pos_s, hv, dense, lz77.GATE_DEPTH, 12, 32768)
        ks, kc = probe.probe_best(*args)
        ps, pc = probe._probe_best_plain(*args)
        torch.cuda.synchronize()
        err = max(int((ks.long() - ps.long()).abs().max()),
                  int((kc.long() - pc.long()).abs().max()))
        if err != 0:
            raise AssertionError(f"K1 dense={dense}: kernel != plain "
                                 f"(max abs err {err})")
        ms = timed(lambda: probe.probe_best(*args), 20)
        plain_ms = timed(lambda: probe._probe_best_plain(*args), 3)
        b_ms, by = bound(B * N * ((W + 2) * 4 + 8) + 4 * B,
                         B * N * dense * PROBE_OPS)
        print(f"K1 probe_best B={B} N={N} W={W} dense={dense}: equal to "
              f"plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({by})", flush=True)
        rows.append(dict(dense=dense, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=by))


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
                bound_by=by, stops=stops, repaired=rep, cleared=clr)


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


def check_k2(lanes: torch.Tensor, rows: list) -> list:
    """K2 against its plain version on the main path's fused and raw steps
    at L6 and L9, on adversarial steps and on edge bounds; the whole
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
    for lv in (6, 9):
        lc = LEVELS[lv]
        core = lz77.lz77_lane(lanes, LANE_HIST, enc_end, hv, lc.chain,
                              lc.lazy, lc.max_lazy, lc.nice, unit=UNIT,
                              good=lc.good)
        raw[lv] = core["step"].contiguous()
    fused = {lv: parse.fused_steps(raw[lv]).contiguous() for lv in (6, 9)}
    cases = []
    for lv in (6, 9):
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


def main_path(data: bytes, level: int) -> dict:
    from zlibng_tpu_torch import compress_cuda
    from zlibng_tpu_torch.ops import deflate, parse, probe
    probe.launches = 0
    parse.launches = 0
    t0 = time.perf_counter()
    out = compress_cuda(data, level)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {"K1": probe.launches, "K2": parse.launches}
    if launches["K1"] == 0 or launches["K2"] == 0:
        raise AssertionError(f"L{level}: main path missed a kernel {launches}")
    if zlib.decompress(out) != data:
        raise AssertionError(f"L{level}: zlib round trip failed")
    t0 = time.perf_counter()
    warm_out = compress_cuda(data, level)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    stages = dict(deflate.stage_seconds)
    if warm_out != out:
        raise AssertionError(f"L{level}: warm run differs from cold run")
    prefix = data[: 1 << 20]
    if compress_cuda(prefix, level) != compress_cuda(prefix, level,
                                                     device="cpu"):
        raise AssertionError(f"L{level}: 1 MiB prefix differs from CPU port")
    t0 = time.perf_counter()
    if compress_cuda(data, level, device="cpu") != out:
        raise AssertionError(f"L{level}: output differs from the CPU port")
    cpu_s = time.perf_counter() - t0
    mbs = len(data) / warm / 1e6
    print(f"main path L{level}: {len(data)} B -> {len(out)} B "
          f"(ratio {len(out) / len(data):.4f}, sha256 "
          f"{hashlib.sha256(out).hexdigest()[:16]}); zlib round trip ok; "
          f"equal to the CPU port on the 1 MiB prefix and on the whole corpus "
          f"({cpu_s:.1f} s on the host); "
          f"launches {launches}; cold {cold:.3f} s, warm {warm:.3f} s = "
          f"{mbs:.3f} MB/s; warm stages: stage1 {stages['stage1']:.3f} s, "
          f"stage2 {stages['stage2']:.3f} s, stitch {stages['stitch']:.3f} s",
          flush=True)
    return dict(level=level, launches=launches, size=len(out),
                warm_s=warm, mb_s=mbs, stages=stages)


def profile_group(data: bytes, level: int = 6) -> None:
    """One lane group (2 MiB) of the main path under torch.profiler: CUDA
    kernel launches, summed kernel time and the device's idle share of
    the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from zlibng_tpu_torch import compress_cuda
    group = data[: 2 << 20]
    compress_cuda(group, level)                       # warm
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as p:
        t0 = time.perf_counter()
        compress_cuda(group, level)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in p.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kern) / 1e6     # us -> s
    if not kern:
        print("profile: the profiler saw no device events (not measured)")
        return
    by_name: dict[str, float] = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    top = sorted(((t, n) for n, t in by_name.items()), reverse=True)[:5]
    print(f"profile L{level} one 2 MiB group: wall {wall:.3f} s (profiled), "
          f"{len(kern)} CUDA kernels, kernel time {busy:.4f} s, device idle "
          f"share {1 - busy / wall:.4f}; top kernels by total device time: "
          + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms" for t, n in top),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from zlibng_tpu_torch import _build

    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    took = _build.build()
    each = ", ".join(f"{k} {v:.2f} s" for k, v in took.items())
    print(f"phase build: {time.perf_counter() - t0:.2f} s ({each or 'cached'})",
          flush=True)
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

    # the timed main path first, so that no earlier phase (allocations,
    # profiler sessions) can skew its end-to-end numbers
    runs = {lv: main_path(data, lv) for lv in (6, 9)}

    dev = torch.device("cuda")
    lanes = first_group_lanes(data, dev)
    k1, k2 = [], []
    check_k1(lanes, k1)
    k2_cases = check_k2(lanes, k2)
    check_estimate(lanes)
    del lanes
    profile_k2(k2_cases, k2)
    del k2_cases
    profile_group(data)

    src = "zlibng_tpu_torch/csrc/"
    kernels = []
    for row, lv in zip(k1, (6, 9)):
        kernels.append(dict(
            name=f"K1 probe_best (dense={row['dense']}, L{lv})", route="cuda",
            source=src + "probe.cu",
            replaces="zlibng_tpu/ops/probe_pallas.py:51",
            launches=runs[lv]["launches"]["K1"],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None))
    for row in k2:
        lv = row["level"]
        kernels.append(dict(
            name=f"K2 parse_select (fused steps, L{lv})", route="cuda",
            source=src + "parse.cu",
            replaces="zlibng_tpu/ops/parse_pallas.py:26",
            launches=runs[lv]["launches"]["K2"],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            device_ms=row.get("device_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
