"""K1: the probe sweep of the LZ77 match engine.

Counterpart of `zlibng_tpu/ops/probe_pallas.py` and of the deep probes
around it (`zlibng_tpu/ops/lz77_jax.py:255-312`). On a CUDA tensor the
dense and the deep probes run in one launch of the hand-written kernel
`csrc/probe.cu`, a walk per sorted row that stops where no later probe can
win; on a CPU tensor they run in the plain version: `_probe_best_plain`,
the shifted-compare loop of `lz77_jax.py:_probe_best_xla` batched over
lanes, then `lz77.deep_probes`. `tests/test_torch_probe_walk.py` holds a
model of the walk against both.
"""
from __future__ import annotations

import torch

from .. import _build
from ..format.constants import WINDOW_SIZE

NEG = -(1 << 30)

# look-behind rows K1 stages in shared memory per 256-row tile (capped at
# the chain): chains up to HALO walk in shared memory alone; deeper probes
# read global memory
HALO = 1024


# `launches`: K1 launches so far (`_build.launches`)
__getattr__ = _build.launch_count("probe")


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
                     good_l16, max_dist, chain, enc_start, enc_end,
                     halo=HALO):
    B, N, W = w2_s.shape
    deep = chain > dense                   # only the deep probes read enc_end
    dev = _build.check_cuda("probe kernel", w2_s, h_sorted, pos_s,
                            hist_valid_from, *([enc_end] if deep else []))
    if h_sorted.shape != (B, N) or pos_s.shape != (B, N) \
            or hist_valid_from.shape != (B,) or W not in (2, 4) \
            or (deep and enc_end.shape != (B,)):
        raise ValueError("probe kernel: bad shapes")
    score, cand = torch.empty((2, B, N), dtype=torch.int32,
                              device=dev).unbind(0)
    _build.launch("probe", dev, w2_s, h_sorted, pos_s, hist_valid_from,
                  enc_end if deep else 0, score, cand, B, N, W, halo, dense,
                  chain, gate_depth, good_l16, max_dist, enc_start)
    return score, cand


def probe_best(w2_s, h_sorted, pos_s, hist_valid_from, dense: int,
               gate_depth: int, good_l16: int, max_dist: int = WINDOW_SIZE,
               chain: int | None = None, enc_start: int = 0, enc_end=None):
    """Probe sweep over B lanes: the dense probes k = 1..dense and, for
    chain > dense, the deep probes k = dense+1..chain of the rows that
    still hunt and can emit (enc_start <= pos < enc_end (B,) int32). A CUDA
    tensor runs the K1 walk, one launch; a CPU tensor the plain version,
    `_probe_best_plain` then `lz77.deep_probes`. Shapes as in
    _probe_best_plain. Rows must be sorted by (hash, pos), as
    lz77.sorted_probe_rows gives them: the walk's early exits rely on it.
    Past dense, the deep gate tests best l16 < good_l16, which must lie in
    [4, 16] there (deep_probes' max(4, min(good, 16)) of the same value)."""
    chain = dense if chain is None else chain
    if not 0 <= dense <= chain or (dense == 0 and chain > 0):
        raise ValueError(f"probe_best: need 1 <= dense <= chain (or both 0),"
                         f" got dense {dense}, chain {chain}")
    if chain > dense and (enc_end is None or not 4 <= good_l16 <= 16):
        raise ValueError("probe_best: the deep probes need enc_end and "
                         "4 <= good_l16 <= 16")
    if w2_s.is_cuda:
        return _probe_best_cuda(w2_s, h_sorted, pos_s, hist_valid_from, dense,
                                gate_depth, good_l16, max_dist, chain,
                                enc_start, enc_end)
    if w2_s.device.type != "cpu":
        raise ValueError(f"probe_best: unsupported device {w2_s.device}")
    return _probe_plain(w2_s, h_sorted, pos_s, hist_valid_from, dense,
                        gate_depth, good_l16, max_dist, chain, enc_start,
                        enc_end)


def _probe_plain(w2_s, h_sorted, pos_s, hist_valid_from, dense, gate_depth,
                 good_l16, max_dist, chain, enc_start, enc_end):
    """K1's plain version on tensors of any device: `_probe_best_plain`,
    then `lz77.deep_probes` for chain > dense."""
    score, cand = _probe_best_plain(w2_s, h_sorted, pos_s, hist_valid_from,
                                    dense, gate_depth, good_l16, max_dist)
    if chain > dense:
        from .lz77 import deep_probes     # lz77 imports this module
        deep_probes(w2_s, h_sorted, pos_s, hist_valid_from, score, cand,
                    enc_start, enc_end.reshape(-1, 1), dense, chain, good_l16,
                    max_dist)
    return score, cand
