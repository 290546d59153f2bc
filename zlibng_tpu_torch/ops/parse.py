"""K2: the greedy/lazy parse chain walk.

Counterpart of `zlibng_tpu/ops/parse_pallas.py`. `parse_select` walks
pos += max(step[pos], 1) from bounds[b, 0] to bounds[b, 1], marking each
stop: on a CUDA tensor in the hand-written kernel `csrc/parse.cu`, on a CPU
tensor in `_parse_select_plain`, the pointer-doubling form of
`zlibng_tpu/ops/lz77_jax.py:_reachable_jax`, batched over lanes. The
kernel speculates per segment of SEG positions and stitches per lane (see
the note in `csrc/parse.cu`); `tests/test_torch_parse_segmented.py` holds
a model of its two phases against the plain version.
"""
from __future__ import annotations

import math

import torch

from .. import _build

# csrc/parse.cu's kSeg and kLead: positions per phase-1 segment, and the
# lead-in its speculative walk starts before each segment (>= 2 x 258, the
# longest match)
SEG = 2048
LEAD = 512


# `launches`: K2 launches so far (`_build.launches`)
__getattr__ = _build.launch_count("parse")


def _reachable_plain(nxt: torch.Tensor, start: torch.Tensor,
                     end: torch.Tensor) -> torch.Tensor:
    """nxt: (B, N) next position of each position; start, end: (B, 1).
    Marks the positions on the chain start -> nxt -> ... below end, by
    pointer doubling over the domain [0, N] with a sentinel at end."""
    B, N = nxt.shape
    dev = nxt.device
    idx = torch.arange(N + 1, dtype=torch.int64, device=dev)
    live = idx < end
    J = torch.where(live, torch.minimum(torch.cat([nxt.long(), end], 1), end),
                    end)
    total = live.long()                    # hops to the sentinel, doubled
    nlev = max(1, int(math.ceil(math.log2(max(N, 2)))) + 1)
    levels = [J]
    for _ in range(nlev - 1):
        Jk = levels[-1]
        total = total + total.gather(1, Jk)
        levels.append(Jk.gather(1, Jk))
    steps = total.gather(1, start) - total
    cur = start.expand(B, N + 1)
    s = steps.clamp(min=0)
    for k in range(nlev - 1, -1, -1):
        use = (s & (1 << k)) > 0
        cur = torch.where(use, levels[k].gather(1, cur), cur)
        s = torch.where(use, s - (1 << k), s)
    on_chain = (cur == idx) & (steps >= 0) & (idx >= start) & live
    return on_chain[:, :N]


def _parse_select_plain(step: torch.Tensor, bounds: torch.Tensor):
    """step: (B, N) int32; bounds: (B, 2) int32. Returns (B, N) bool."""
    B, N = step.shape
    start = bounds[:, 0:1].long()
    end = bounds[:, 1:2].long()
    pos = torch.arange(N, dtype=torch.int64, device=step.device)
    nxt = torch.minimum(pos + step.long().clamp(min=1), end)
    return _reachable_plain(nxt, start, end)


def _parse_select_cuda(step: torch.Tensor, bounds: torch.Tensor):
    """Runs K2 on CUDA tensors: returns the (B, N) bool mask and the (B, 2)
    int32 count of segments each lane's stitch repaired and cleared."""
    B, N = step.shape
    dev = _build.check_cuda("parse kernel", step, bounds)
    if bounds.shape != (B, 2):
        raise ValueError("parse kernel: bounds must be (B, 2)")
    if B > 65535:
        raise ValueError("parse kernel: needs B <= 65535")
    sel = torch.empty((B, N), dtype=torch.bool, device=dev)
    stats = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return sel, stats.zero_()
    guess = torch.empty((B, -(-N // SEG), 2), dtype=torch.int32, device=dev)
    _build.launch("parse", dev, step, bounds, sel, guess, stats, B, N)
    return sel, stats


def parse_select(step: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """step: (B, N) int32 jump sizes; bounds: (B, 2) int32 [start, end) with
    0 <= start. Returns the (B, N) bool mask of the walk's stops: the K2
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if step.is_cuda:
        return _parse_select_cuda(step, bounds)[0]
    if step.device.type != "cpu":
        raise ValueError(f"parse_select: unsupported device {step.device}")
    return _parse_select_plain(step, bounds)


def fused_steps(step: torch.Tensor) -> torch.Tensor:
    """The encode path's fused step array: a match keeps its step, a
    literal jumps to the next match start (or past the lane's end), so the
    walk makes one stop per selected match or literal-run start."""
    B, N = step.shape
    pos = torch.arange(N, dtype=torch.int32, device=step.device)
    is_m = step > 1
    nm = torch.where(is_m, pos, N).flip(1).cummin(1).values.flip(1)
    return torch.where(is_m, step, nm - pos).to(torch.int32)


def parse_select_encode(step: torch.Tensor, bounds: torch.Tensor):
    """Encode-path parse, the same selection as parse_select(step, bounds)
    (zlibng_tpu/ops/parse_pallas.py:parse_select_encode): walk the fused
    step array, then recover the literals between stops as the in-range
    positions not covered by a selected match (cummax cover)."""
    B, N = step.shape
    pos = torch.arange(N, dtype=torch.int32, device=step.device)
    is_m = step > 1
    visited = parse_select(fused_steps(step), bounds)
    msel = visited & is_m
    run = torch.where(msel, pos + step, 0).cummax(1).values
    covered = pos < torch.cat([torch.zeros_like(run[:, :1]), run[:, :-1]], 1)
    return (pos >= bounds[:, 0:1]) & (pos < bounds[:, 1:2]) & ~covered
