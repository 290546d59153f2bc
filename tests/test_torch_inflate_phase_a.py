"""Decode phase A of the port (`ops/inflate.py`: `_build_flat_luts`,
`_phase_a`) against the JAX package's (`ops/inflate_tpu.py`) on the same
wave: dynamic and fixed tables, a lane that meets an invalid code, a lane
whose slice start is clamped, and padding lanes with mask 0, at cb 2048
and 16384. All six outputs must be equal: tolerance none."""
import functools
import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zlibng_tpu.ops import inflate_tpu as itpu
from zlibng_tpu_torch.ops import inflate as ti
from zlibng_tpu_torch.stream.inflate_serial import RawInflater

from torch_corpus import crafted_streams, pigz, raw_deflate, sample


def _lanes():
    """(raw stream, name) of each real lane: its first block is decoded."""
    rng = np.random.default_rng(3)
    junk = bytes([0b011]) + rng.integers(0, 256, 3000, np.uint8).tobytes()
    return [(raw_deflate(pigz()[:40000]), "dynamic, pigz"),
            (raw_deflate(sample("text", 30000), 6, strategy=zlib.Z_FIXED),
             "fixed"),
            (raw_deflate(sample("a16", 8000), 9), "dynamic, 16 symbols"),
            (crafted_streams()["invalid literal/length code"], "invalid"),
            (junk, "fixed tables over random bytes"),
            (raw_deflate(sample("runs", 30000), 1),
             "dynamic, runs (clamped)")]


@functools.lru_cache(maxsize=None)
def _wave(cb: int):
    """One phase A wave over the lanes, laid out as _decode_segments lays
    a wave out, plus two padding lanes (B = 8)."""
    lanes = _lanes()
    comp = b""
    B = 8
    lits = np.zeros((B, 48 + 288), np.int32)
    dists = np.zeros((B, 48 + 30), np.int32)
    byte_starts = np.zeros(B, np.int32)
    start_bits = np.zeros(B, np.int32)
    lit_masks = np.zeros(B, np.int32)
    dist_masks = np.zeros(B, np.int32)
    lit_cap = dist_cap = 512
    for i, (raw, name) in enumerate(lanes):
        inf = RawInflater()
        inf.feed(raw)
        cur = ti._Cursor(0, None)
        kind, lt, dt, (wl, wd), sym_bit = ti._parse_header(inf, cur)
        assert kind == "huff", name
        base = len(comp)
        comp += raw + bytes(-len(raw) % 64)
        lits[i, :lt.size] = lt
        dists[i, :dt.size] = dt
        lit_masks[i] = (1 << wl) - 1
        dist_masks[i] = (1 << wd) - 1
        lit_cap = max(lit_cap, 1 << wl)
        dist_cap = max(dist_cap, 1 << wd)
        byte_starts[i] = base + (sym_bit >> 3)
        start_bits[i] = sym_bit & 7
    cap = max(2048, 1 << (len(comp) - 1).bit_length())
    comp_pad = np.zeros(cap + cb, np.uint8)
    comp_pad[:len(comp)] = np.frombuffer(comp, np.uint8)
    # the last real lane's bytes again at cap, the last start a slice of cb
    # bytes can take; its start points past it and is clamped back there
    last = len(lanes) - 1
    comp_pad[cap:] = comp_pad[byte_starts[last]:][:cb].copy()
    byte_starts[last] = cap + 7
    return (comp_pad, byte_starts, lits, dists, start_bits, lit_masks,
            dist_masks, cb, lit_cap, dist_cap)


def _as_torch(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]


def _as_jax(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args]


@pytest.mark.parametrize("cb", [2048, 16384])
def test_flat_luts_match_reference(cb):
    _, _, lits, dists, _, lit_masks, dist_masks, _, lit_cap, dist_cap = \
        _wave(cb)
    for tabs, masks, cap in ((lits, lit_masks, lit_cap),
                             (dists, dist_masks, dist_cap)):
        got = ti._build_flat_luts(torch.from_numpy(tabs),
                                  torch.from_numpy(masks), cap).numpy()
        want = np.asarray(itpu._build_flat_luts(jnp.asarray(tabs),
                                                jnp.asarray(masks), cap))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32


@pytest.mark.parametrize("cb", [2048, 16384])
def test_phase_a_matches_reference(cb):
    args = _wave(cb)
    got = ti._phase_a(*_as_torch(args))
    want = itpu._phase_a(*_as_jax(args))
    names = ("tok_kind", "tok_aux", "ntok", "spec_idx", "spec_kind",
             "spec_end")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "tok_aux":           # the reference's uint32 bits
            g = g.view(np.uint32)
        assert g.dtype == w.dtype or name != "tok_kind", name
        np.testing.assert_array_equal(g, w, err_msg=name)
    spec_kind = got[4].numpy()
    ntok = got[2].numpy()
    # the wave reaches every outcome the host interprets: an EOB, an
    # invalid code, and padding lanes with no token past their first
    assert (spec_kind == ti.K_EOB).any() and (spec_kind == ti.K_INVALID).any()
    assert ntok[-2:].tolist() == [1, 1]


def test_phase_a_steps_feed_the_walk():
    """The walk's input: EOB and invalid positions step by 1 << 26, every
    other step is the token's bit count (1-48), bounds start at each
    lane's first symbol bit and end at N."""
    args = _wave(2048)
    step, bounds, kind, packed, tend = ti._phase_a_steps(*_as_torch(args))
    B, N = step.shape
    assert N == 8 * 2048 and step.dtype == torch.int32
    big = (kind >= ti.K_EOB)
    assert bool((step[big] == ti._BIG).all())
    assert int(step[~big].min()) >= 1 and int(step[~big].max()) <= 48
    assert bounds[:, 1].tolist() == [N] * B
    assert bounds[:, 0].tolist() == args[4].tolist()
    pos = torch.arange(N, dtype=torch.int32)
    assert bool(((tend - pos)[~big] == step[~big]).all())
