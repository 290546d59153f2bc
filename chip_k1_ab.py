#!/usr/bin/env python3
"""K1 of two trees, and variants of this tree's K1, timed on one card.

    python3 chip_k1_ab.py [PARENT_DIR]

Builds `zlibng_tpu_torch/csrc/probe.cu` of this tree, of PARENT_DIR (a
tree unpacked with `git archive`, optional) and of a copy of this tree's
source with 128-row tiles, then holds each against the plain version and
times it at K1's operating points of chip_smoke.py (the first lane group:
B = 8 lanes of N = 294,912 sorted rows; dense 16, 64, 2 and the chain-128
tune, the last also with a 64-row halo). Times are device time per launch:
CUDA events around 30 back-to-back launches, median of 5, the builds taken
in turns (parent, this tree, this tree, parent). A parent whose K1 is the
dense sweep alone skips the chain-128 point. Prints one line per reading
and, as its last line, a JSON object with all of them.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def build(tag: str, src: str, out_dir: Path):
    """nvcc `src` (probe.cu text) into a library; its C entry with the
    argument types of its signature, and whether it takes the deep probes."""
    from zlibng_tpu_torch import _build
    cu = out_dir / f"probe_{tag}.cu"
    so = out_dir / f"probe_{tag}.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).zng_probe_best
    walk = "const void* enc_end" in src
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 7 + [I] * 10 + [P]) if walk else (
        [P] * 6 + [I] * 7 + [P])
    fn.restype = I
    return fn, walk


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_k1_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from zlibng_tpu_torch import _build
    from zlibng_tpu_torch.ops import lz77, probe
    from zlibng_tpu_torch.ops.deflate import LANE_HIST
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "probe.cu").read_text()
    tile = "constexpr int kTile = 256;"
    builds = {"change": build("change", src, out_dir)}
    if tile in src:
        builds["change, 128-row tiles"] = build(
            "tile128", src.replace(tile, "constexpr int kTile = 128;"),
            out_dir)
    if len(sys.argv) > 1:
        parent = Path(sys.argv[1]) / "zlibng_tpu_torch" / "csrc" / "probe.cu"
        builds["parent"] = build("parent", parent.read_text(), out_dir)

    dev = torch.device("cuda")
    data, _ = cs.corpus()
    lanes = cs.first_group_lanes(data, dev)
    B, N = lanes.shape
    pad = torch.cat([lanes, lanes.new_zeros((B, 16))], 1)
    w2, h, p, _ = lz77.sorted_probe_rows(lz77._build_w4(pad), N)
    hv = torch.zeros(B, dtype=torch.int32, device=dev)
    hv[0] = LANE_HIST
    ee = torch.full((B,), N, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((2, B, N), dtype=torch.int32, device=dev)
    print(f"{torch.cuda.get_device_name(0)}; K1 at B={B} N={N}", flush=True)

    def launch(fn, walk, dense, chain, good, halo):
        if walk:
            return fn(w2.data_ptr(), h.data_ptr(), p.data_ptr(),
                      hv.data_ptr(), ee.data_ptr(), out[0].data_ptr(),
                      out[1].data_ptr(), B, N, 4, halo, dense, chain, 16,
                      good, 32768, LANE_HIST, stream)
        return fn(w2.data_ptr(), h.data_ptr(), p.data_ptr(), hv.data_ptr(),
                  out[0].data_ptr(), out[1].data_ptr(), B, N, 4, dense, 16,
                  good, 32768, stream)

    def per_launch_ms(run, n=30):
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                run()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / n)
        return statistics.median(times)

    readings = []
    for name, _, chain, good in cs.k1_points():
        dense, good = min(chain, lz77.DENSE_PROBES), max(4, min(good, 16))
        want = probe._probe_plain(w2, h, p, hv, dense, lz77.GATE_DEPTH, good,
                                  32768, chain, LANE_HIST, ee)
        halos = (probe.HALO, cs.SHORT_HALO) if chain > cs.SHORT_HALO else (
            probe.HALO,)
        order = ["parent", "change", "change", "parent"] + [
            k for k in builds if k not in ("parent", "change")]
        for tag in order:
            if tag not in builds:
                continue
            fn, walk = builds[tag]
            if chain > dense and not walk:
                continue
            for halo in halos if walk else (0,):
                def run():
                    err = launch(fn, walk, dense, chain, good, halo)
                    if err:
                        raise RuntimeError(f"{tag}: CUDA error {err}")
                run()
                torch.cuda.synchronize()
                if not (torch.equal(out[0], want[0])
                        and torch.equal(out[1], want[1])):
                    raise AssertionError(f"K1 {tag} {name}: != plain")
                ms = per_launch_ms(run)
                print(f"K1 {name}, {tag}" + (f", halo {halo}" if walk else "")
                      + f": equal to plain; {ms:.4f} ms per launch",
                      flush=True)
                readings.append(dict(point=name, build=tag, halo=halo,
                                     ms=ms))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
