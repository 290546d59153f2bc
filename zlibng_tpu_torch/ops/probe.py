"""K1: the dense probe sweep of the LZ77 match engine.

Counterpart of `zlibng_tpu/ops/probe_pallas.py`. On a CUDA tensor the sweep
runs in the hand-written kernel `csrc/probe.cu`; on a CPU tensor it runs in
`_probe_best_plain`, the shifted-compare loop of
`zlibng_tpu/ops/lz77_jax.py:_probe_best_xla`, batched over lanes.
"""
from __future__ import annotations

import torch

from .. import _build
from ..format.constants import WINDOW_SIZE

NEG = -(1 << 30)

# kernel launches so far (a run resets it to show which path it took)
launches = 0


def _ctz_bytes32(x: torch.Tensor) -> torch.Tensor:
    """Leading equal bytes of an xor word (any integer dtype holding 32
    bits): ctz(x) / 8, 4 when x == 0 — the index of the first nonzero byte."""
    return torch.where(
        (x & 0xFF) != 0, 0,
        torch.where((x & 0xFFFF) != 0, 1,
                    torch.where((x & 0xFFFFFF) != 0, 2,
                                torch.where(x != 0, 3, 4)))).to(torch.int32)


def _probe_best_plain(w2_s, h_sorted, pos_s, hist_valid_from, dense: int,
                      gate_depth: int, good_l16: int,
                      max_dist: int = WINDOW_SIZE):
    """w2_s: (B, N, W) int32 probe words; h_sorted, pos_s: (B, N) int32;
    hist_valid_from: (B,) int32. Returns (best_score, best_cand) (B, N)."""
    B, N, W = w2_s.shape
    hv = hist_valid_from.reshape(B, 1)
    best_score = torch.full((B, N), NEG, dtype=torch.int32,
                            device=pos_s.device)
    best_cand = torch.zeros_like(best_score)
    hunting = None
    for k in range(1, dense + 1):
        if k == gate_depth + 1:
            cur = torch.where(best_score > NEG,
                              (best_score + (pos_s - best_cand)) >> 20, 0)
            hunting = cur < good_l16
        zk = torch.zeros((B, k), dtype=torch.int32, device=pos_s.device)
        cand = torch.cat([zk, pos_s[:, :N - k]], dim=1)
        same = torch.cat([zk.bool(), h_sorted[:, k:] == h_sorted[:, :N - k]],
                         dim=1)
        prev = torch.cat([torch.zeros_like(w2_s[:, :k]), w2_s[:, :N - k]],
                         dim=1)
        x = w2_s ^ prev
        l16 = _ctz_bytes32(x[..., W - 1])
        for w in range(W - 2, -1, -1):
            l16 = torch.where(x[..., w] != 0, _ctz_bytes32(x[..., w]),
                              4 + l16)
        dist = pos_s - cand
        ok = same & (cand >= hv) & (dist <= max_dist) & (dist > 0)
        score = torch.where(ok, (l16 << 20) - dist, NEG)
        better = score > best_score
        if hunting is not None:
            better = better & hunting
        best_score = torch.where(better, score, best_score)
        best_cand = torch.where(better, cand, best_cand)
    return best_score, best_cand


def _probe_best_cuda(w2_s, h_sorted, pos_s, hist_valid_from, dense, gate_depth,
                     good_l16, max_dist):
    global launches
    B, N, W = w2_s.shape
    for t in (w2_s, h_sorted, pos_s, hist_valid_from):
        if t.dtype != torch.int32 or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(
                "probe kernel takes contiguous int32 CUDA tensors")
    if h_sorted.shape != (B, N) or pos_s.shape != (B, N) \
            or hist_valid_from.shape != (B,) or W not in (2, 4) \
            or not 1 <= dense <= 64:
        raise ValueError("probe kernel: bad shapes or dense")
    fn = _build.kernel("probe")
    score = torch.empty((B, N), dtype=torch.int32, device=w2_s.device)
    cand = torch.empty_like(score)
    with torch.cuda.device(w2_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(w2_s.data_ptr(), h_sorted.data_ptr(), pos_s.data_ptr(),
                 hist_valid_from.data_ptr(), score.data_ptr(), cand.data_ptr(),
                 B, N, W, dense, gate_depth, good_l16, max_dist, stream)
    _build.check(err, "probe kernel")
    launches += 1
    return score, cand


def probe_best(w2_s, h_sorted, pos_s, hist_valid_from, dense: int,
               gate_depth: int, good_l16: int, max_dist: int = WINDOW_SIZE):
    """Dense probe sweep over B lanes: the K1 kernel for CUDA tensors, the
    plain version for CPU tensors. Shapes as in _probe_best_plain."""
    if w2_s.is_cuda:
        return _probe_best_cuda(w2_s, h_sorted, pos_s, hist_valid_from, dense,
                                gate_depth, good_l16, max_dist)
    if w2_s.device.type != "cpu":
        raise ValueError(f"probe_best: unsupported device {w2_s.device}")
    return _probe_best_plain(w2_s, h_sorted, pos_s, hist_valid_from, dense,
                             gate_depth, good_l16, max_dist)
