"""K1's run-bounded probe walk, modelled in numpy, against the plain
version and the JAX package.

The CUDA kernel (`zlibng_tpu_torch/csrc/probe.cu`) cannot run on a CPU, so
`_walk` mirrors it row by row (every row's walk advanced in lock step over
k): the staged candidates K over the tile's rows and its halo (the
kernel gallops then bisects; the model bisects, the same K since the
predicate is monotone), the exits tested probe by probe only past them (run start,
window or history), saturation at l16 = 4 * W, the chain end, the two
gates (the dense gate at gate_depth + 1, the deep gate at dense + 1) and
the masked filter before the exact strict update. It must equal `probe_best`'s CPU route (`_probe_best_plain`, then
`lz77.deep_probes`) on chip_smoke.py's adversarial lanes (zeros, uniform
random, period 3 and 4, two symbols, same-hash runs of a short halo's
length and one and two more) and on text, with the default halo and (for
chains beyond it) the short one, for every case of
`chip_smoke.WALK_CASES` with hist_valid_from at 0, the history's end and
its middle and enc_end cutting runs; and, standing in for K1 inside
`lz77_lane` at chain 128, the reference's `lz77_lane` (its
`_probe_best_xla` path plus the compacted deep probes). Change the model
with the kernel. Tolerance: none (integer outputs).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from zlibng_tpu.ops import lz77_jax as ref
from zlibng_tpu_torch.ops import lz77 as tlz
from zlibng_tpu_torch.ops import probe as tprobe

from torch_corpus import sample

N = 4096
HIST = 1024                       # lanes are [history | payload]
NEG = tprobe.NEG
GATE = tlz.GATE_DEPTH


TILE = 256                        # csrc/probe.cu's kTile


def _walk(w2_s, h_s, pos_s, hv, enc_end, dense, chain, gate_depth,
          good_l16, max_dist, enc_start, halo=tprobe.HALO):
    """csrc/probe.cu's probe_walk on numpy inputs, every row's walk advanced
    in lock step over k. Returns (best_score, best_cand, probes): probes
    counts the candidates each row visited."""
    B, n, W = w2_s.shape
    halo = max(1, min(halo, chain))
    u = w2_s.view(np.uint32).astype(np.int64)
    h = h_s.astype(np.int64)
    p = pos_s.astype(np.int64)
    bs = np.full((B, n), NEG, np.int64)
    bc = np.zeros((B, n), np.int64)
    bl = np.full((B, n), -1, np.int64)
    mask = np.zeros((B, n, W), np.int64)      # bytes 0..bl of the probe
    probes = np.zeros((B, n), np.int64)
    lo = np.maximum(hv.astype(np.int64)[:, None], p - max_dist)
    row = np.arange(n)[None].repeat(B, 0)

    lane = np.arange(B)[:, None]

    def cand_ok(k):       # same hash, lo <= cpos < pos; k (B, n) or an int
        j = np.maximum(row - k, 0)
        return (row >= k) & (h[lane, j] == h) & (p[lane, j] >= lo) \
            & (p[lane, j] < p)

    # S: the staged rows behind each row; K: the staged candidates, by the
    # kernel's binary search over k in [0, S] (the predicate is monotone)
    S = np.minimum(chain, row % TILE + halo)
    K, hi = np.zeros((B, n), np.int64), S + 1
    while (hi - K > 1).any():
        mid = (K + hi) >> 1
        ok = (hi - K > 1) & cand_ok(mid)
        K, hi = np.where(ok, mid, K), np.where(ok | (hi - K <= 1), hi, mid)
    kend = np.where(K == S, chain, K)
    can_emit = (chain > dense) & (p >= enc_start) & (p < enc_end[:, None])
    live = np.ones((B, n), bool)
    for k in range(1, chain + 1):
        live &= k <= kend
        bi, ri = np.nonzero(live)
        if bi.size == 0:
            break
        cur = np.maximum(bl[bi, ri], 0)
        stop = np.zeros(bi.size, bool)
        if k == gate_depth + 1 and k <= dense:
            stop |= cur >= good_l16            # the dense gate
        if k == dense + 1:
            stop |= ~((cur < good_l16) & can_emit[bi, ri])   # the deep gate
        live[bi[stop], ri[stop]] = False
        bi, ri = bi[~stop], ri[~stop]
        probes[bi, ri] += 1
        # staged probes (k <= K) are candidates; past them, the exits
        j = np.maximum(ri - k, 0)
        cp = p[bi, j]
        out = (k > K[bi, ri]) & ~((ri >= k) & (h[bi, j] == h[bi, ri])
                                  & (cp >= lo[bi, ri]) & (cp < p[bi, ri]))
        x = np.bitwise_or.reduce((u[bi, ri] ^ u[bi, j]) & mask[bi, ri], 1)
        go = ~out & (x == 0)                   # the filter: l16 > bl
        gi, gr, gj, gcp = bi[go], ri[go], j[go], cp[go]
        l16 = _probe_len(u[gi, gr] ^ u[gi, gj], W)
        sc = (l16 << 20) - (p[gi, gr] - gcp)
        up = sc > bs[gi, gr]
        ui, ur = gi[up], gr[up]
        bs[ui, ur], bc[ui, ur], bl[ui, ur] = sc[up], gcp[up], l16[up]
        nbytes = l16[up][:, None] + 1 - 4 * np.arange(W)[None]
        nb = np.clip(nbytes, 0, 4)
        mask[ui, ur] = np.where(nb == 4, 0xFFFFFFFF, (1 << (8 * nb)) - 1)
        sat = np.zeros(bi.size, bool)
        sat[np.flatnonzero(go)[up]] = l16[up] == 4 * W
        live[bi[out | sat], ri[out | sat]] = False
    return bs.astype(np.int32), bc.astype(np.int32), probes


def _probe_len(xw, W):
    """l16 of xor words (M, W): leading equal bytes, word 0 first."""
    l16 = np.where(xw[:, W - 1] != 0, _ctz_bytes(xw[:, W - 1]), 4)
    for w in range(W - 2, -1, -1):
        l16 = np.where(xw[:, w] != 0, _ctz_bytes(xw[:, w]), 4 + l16)
    return l16


def _ctz_bytes(x):
    """Index of the first nonzero byte of nonzero words (low byte first)."""
    return np.where(x & 0xFF, 0, np.where(x & 0xFFFF, 1,
                                          np.where(x & 0xFFFFFF, 2, 3)))


def _walk_bound(h_s: np.ndarray, chain: int) -> np.ndarray:
    """The most probes each sorted row's walk can make: its offset in its
    same-hash run plus the probe that meets the run's start, at most the
    chain and the rows before it (chip_smoke.py's walk_probe_bound)."""
    n = h_s.shape[1]
    r = np.arange(n)[None]
    start = np.where(np.concatenate(
        [np.ones((h_s.shape[0], 1), bool), h_s[:, 1:] != h_s[:, :-1]], 1),
        r, 0)
    off = r - np.maximum.accumulate(start, 1)
    return np.minimum(np.minimum(off + 1, chain), r)


@functools.lru_cache(maxsize=None)
def _inputs(case: int):
    text = {"text": np.frombuffer(sample("pigz", N), np.uint8),
            "cve text": np.frombuffer(sample("cve", N), np.uint8)}
    names, *ts = chip_smoke.walk_inputs(N, HIST, case, "cpu", extra=text)
    return names, tuple(ts)


@pytest.mark.parametrize("name", sorted(chip_smoke.WALK_CASES))
@pytest.mark.parametrize("turn", [0, 1, 2])
def test_walk_model_matches_plain(name, turn):
    """Every WALK_CASES case over every lane, hist_valid_from and enc_end
    (turned across the three turns)."""
    dense, chain, good_l16, max_dist = chip_smoke.WALK_CASES[name]
    names, (w2_s, h_s, pos_s, hv, enc_end) = _inputs(turn)
    tlz.deep_stats.update(rows=0, chunks=0)
    ps, pc = tprobe.probe_best(w2_s, h_s, pos_s, hv, dense, GATE, good_l16,
                               max_dist, chain=chain, enc_start=HIST,
                               enc_end=enc_end)
    ms, mc, probes = _walk(w2_s.numpy(), h_s.numpy(), pos_s.numpy(),
                           hv.numpy(), enc_end.numpy(), dense, chain, GATE,
                           good_l16, max_dist, HIST)
    for i, lane in enumerate(names):
        np.testing.assert_array_equal(ms[i], ps[i].numpy(), err_msg=lane)
        np.testing.assert_array_equal(mc[i], pc[i].numpy(), err_msg=lane)
    if chain > chip_smoke.SHORT_HALO:     # deep probes from global memory
        s2, c2, _ = _walk(w2_s.numpy(), h_s.numpy(), pos_s.numpy(),
                          hv.numpy(), enc_end.numpy(), dense, chain, GATE,
                          good_l16, max_dist, HIST, chip_smoke.SHORT_HALO)
        np.testing.assert_array_equal(s2, ps.numpy())
        np.testing.assert_array_equal(c2, pc.numpy())
    # the walk visits at most each row's earlier run rows and the row that
    # ends the run, up to the chain
    assert (probes <= _walk_bound(h_s.numpy(), chain)).all()
    if chain > dense:
        assert tlz.deep_stats["rows"] > 0
    # zeros: one run over the lane, and every row saturates at k = 1 (or
    # has no candidate in its usable history)
    z = names.index("zeros")
    assert probes[z].max() == 1


def test_walk_exits_cut_the_walk():
    """The exits are what bounds the walk: at chain 2048 with good 16 the
    rows of the random lane stop within their short runs, and the halo
    runs' deepest rows walk the whole run, past a 64-row halo."""
    # turn 2 gives the halo runs lane hist_valid_from HIST and enc_end N:
    # every run row may emit and every candidate lies in usable history
    names, (w2_s, h_s, pos_s, hv, enc_end) = _inputs(2)
    *_, probes = _walk(w2_s.numpy(), h_s.numpy(), pos_s.numpy(), hv.numpy(),
                       enc_end.numpy(), 64, 2048, GATE, 16, 32768, HIST,
                       chip_smoke.SHORT_HALO)
    rnd = probes[names.index("uniform random")]
    assert rnd.max() < 10 and rnd.mean() < 1.1   # ~1: the run-start probe
    i = names.index("halo runs")
    h = h_s[i].numpy()
    vals, counts = np.unique(h, return_counts=True)
    for n_run in chip_smoke.HALO_RUNS:
        # the deepest row probes its n_run - 1 run rows, and the row before
        # the run too where that lies past the staged rows
        rows = np.isin(h, vals[counts == n_run])
        assert rows.any() and probes[i][rows].max() in (n_run - 1, n_run)
    assert max(chip_smoke.HALO_RUNS) - 1 == chip_smoke.SHORT_HALO + 1


@pytest.mark.parametrize("chain,good", [(128, 12)])
def test_walk_in_lz77_lane_matches_reference(monkeypatch, chain, good):
    """The model standing in for K1 (dense and deep probes in one walk)
    inside the port's lz77_lane gives the reference lz77_lane's arrays."""
    lanes = chip_smoke.walk_lanes(N)
    lanes["text"] = np.frombuffer(sample("pigz", N), np.uint8)
    data = np.stack(list(lanes.values()))
    B = data.shape[0]
    enc_end = np.array([N, N - 333, 2560] * 3, np.int32)[:B]
    hv = np.array([0, HIST, HIST // 2] * 3, np.int32)[:B]

    def walk(w2_s, h_s, pos_s, hv_, dense, gate, good_l16, max_dist,
             chain, enc_start, enc_end):
        s, c, _ = _walk(w2_s.numpy(), h_s.numpy(), pos_s.numpy(), hv_.numpy(),
                        enc_end.numpy(), dense, chain, gate, good_l16,
                        max_dist, enc_start)
        return torch.from_numpy(s), torch.from_numpy(c)

    fn = jax.jit(jax.vmap(lambda d, e, h: ref.lz77_lane(
        d, jnp.int32(HIST), e, h, chain, True, 32, 258, unit=1024,
        good=good)))
    want = {k: np.asarray(v) for k, v in fn(
        jnp.asarray(data), jnp.asarray(enc_end), jnp.asarray(hv)).items()}
    monkeypatch.setattr(tlz, "probe_best", walk)
    got = tlz.lz77_lane(torch.from_numpy(data), HIST,
                        torch.from_numpy(enc_end), torch.from_numpy(hv),
                        chain, True, 32, 258, unit=1024, good=good)
    for k in ("step", "take", "blen", "bdist"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def walk_counts() -> None:
    """The model's probes on chip_smoke.py's first lane group (B = 8 lanes
    of N = 294,912 rows) at K1's operating points: the probes made, and the
    share of lanes busy in a warp (32 rows) and of warps busy in a block
    (256 rows) when each lasts as long as its longest walk. Run from the
    repo's root: python -c "import sys; sys.path[:0] = ['.', 'tests'];
    import test_torch_probe_walk as t; t.walk_counts()" """
    from chip_smoke import corpus, first_group_lanes, k1_points
    data, _ = corpus()
    lanes = first_group_lanes(data, "cpu")
    B, n = lanes.shape
    pad = torch.cat([lanes, lanes.new_zeros((B, 16))], 1)
    w2_s, h_s, pos_s, _ = tlz.sorted_probe_rows(tlz._build_w4(pad), n)
    hv = np.zeros(B, np.int32)
    hv[0] = 32768
    enc_end = np.full(B, n, np.int32)
    for name, _, chain, good in k1_points():
        *_, probes = _walk(w2_s.numpy(), h_s.numpy(), pos_s.numpy(), hv,
                           enc_end, min(chain, tlz.DENSE_PROBES), chain,
                           GATE, max(4, min(good, 16)), 32768, 32768)
        warp = probes.reshape(B, n // 32, 32).max(2)
        block = warp.reshape(B, n // TILE, TILE // 32)
        print(f"{name}: {int(probes.sum())} probes; warps "
              f"{probes.sum() / (32 * warp.sum()):.3f} busy, blocks "
              f"{block.sum() / (block.shape[2] * block.max(2).sum()):.3f} "
              f"busy", flush=True)
