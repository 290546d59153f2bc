"""The segmented K2 walk, modelled in numpy, against the plain version and
the JAX package.

The CUDA kernel (`zlibng_tpu_torch/csrc/parse.cu`) cannot run on a CPU, so
`_model` mirrors its two phases step for step: phase 1 speculates each
segment of S positions from a lead-in of V positions and writes every byte
of the segment; phase 2 stitches each lane, keeping a segment whose guess
was the true entry, repairing one whose guess was wrong (walk from the
true entry until it meets a speculative stop or leaves the segment, and
replace the marks before that point) and clearing one the true walk jumps
over. Tiny segments make every branch run. The result must equal `_parse_select_plain` and the JAX
package's `parse_select` (its CPU route) exactly: tolerance none.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zlibng_tpu.ops.parse_pallas import parse_select as ref_parse_select
from zlibng_tpu_torch.ops import lz77 as tlz
from zlibng_tpu_torch.ops import parse as tparse

from torch_corpus import sample

N = 4096
BOUNDS = np.array([[0, N], [100, 3000], [2048, 2049], [500, 500],
                   [N - 7, N]], np.int32)
BIG = 1 << 26                    # decode phase A's terminator step
I32_MAX = 2 ** 31 - 1
_ref = jax.jit(ref_parse_select)   # one compile per shape, not per op


def _next(i: int, st: int, end: int) -> int:
    s = st if st > 1 else 1
    return end if s >= end - i else i + s


def _model(step: np.ndarray, bounds: np.ndarray, S: int, V: int):
    """The two phases of csrc/parse.cu at kSeg = S and kLead = V. Returns
    (mask, counts): counts of repaired segments, repairs that met the
    speculative path, and cleared segments."""
    B, n_pos = step.shape
    nseg = -(-n_pos // S)
    sel = np.full((B, n_pos), 7, np.uint8)      # every byte must be written
    guess = np.zeros((B, nseg, 2), np.int64)
    counts = dict(repaired=0, merged=0, cleared=0)
    for b in range(B):
        st = step[b].tolist()
        start, end = int(bounds[b, 0]), min(int(bounds[b, 1]), n_pos)
        # phase 1: one warp per segment
        for k in range(nseg):
            lo = k * S
            n = min(S, n_pos - lo)
            mask = np.zeros(n, np.uint8)
            g = x = end
            if 0 <= start < end and lo < end and start < lo + n:
                i = max(start, lo - V, 0)
                while i < lo:
                    i = _next(i, st[i], end)
                g = i
                while i < min(lo + n, end):
                    mask[i - lo] = 1
                    i = _next(i, st[i], end)
                x = i
            guess[b, k] = g, x
            sel[b, lo:lo + n] = mask
        # phase 2: one block per lane
        if not 0 <= start < end:
            continue
        e = start
        for k in range(start // S, (end - 1) // S + 1):
            lo = k * S
            he = min(lo + S, end)
            g, x = guess[b, k]
            if e == g:
                e = x
                continue
            if e >= he:
                if g < he:
                    sel[b, lo:he] = 0
                    counts["cleared"] += 1
                continue
            m = sel[b, lo:he].copy()
            i, c = e, he
            while i < he:
                if m[i - lo]:
                    c = i
                    break
                m[i - lo] = 2
                i = _next(i, st[i], end)
            e = x if c < he else i
            j = np.arange(lo, he)
            sel[b, lo:he] = (m == 2) | ((j >= c) & (m == 1))
            counts["repaired"] += 1
            counts["merged"] += c < he
    assert sel.max() <= 1
    return sel.astype(bool), counts


def _random_steps(seed: int, rate: float, shape=(BOUNDS.shape[0], N)):
    """Literals (1) and matches (3..258) at the given match rate."""
    rng = np.random.default_rng(seed)
    is_m = rng.random(shape) < rate
    return np.where(is_m, rng.integers(3, 259, shape), 1).astype(np.int32)


def _fused(step: np.ndarray) -> np.ndarray:
    return tparse.fused_steps(torch.from_numpy(step)).numpy()


def _sprinkle(seed: int, value: int, rate: float) -> np.ndarray:
    base = _random_steps(seed, 0.3)
    rng = np.random.default_rng(seed + 1)
    return np.where(rng.random(base.shape) < rate, value, base).astype(
        np.int32)


def _negative(seed: int) -> np.ndarray:
    base = _random_steps(seed, 0.3)
    rng = np.random.default_rng(seed + 1)
    neg = rng.integers(-2 ** 31, 0, base.shape, dtype=np.int64)
    return np.where(rng.random(base.shape) < 0.5, neg, base).astype(np.int32)


def _full(v: int) -> np.ndarray:
    return np.full((BOUNDS.shape[0], N), v, np.int32)


CASES = {
    "all_3": lambda: _full(3),
    "all_258": lambda: _full(258),
    "all_literal_fused": lambda: _fused(_full(1)),
    "zeros": lambda: _full(0),
    "negative": lambda: _negative(11),
    "big_terminator": lambda: _sprinkle(12, BIG, 0.01),
    "all_big": lambda: _full(BIG),
    "int32_max": lambda: _sprinkle(13, I32_MAX, 0.01),
    "all_int32_max": lambda: _full(I32_MAX),
    **{f"raw_{r}": functools.partial(_random_steps, 20 + i, r)
       for i, r in enumerate((0.0, 0.05, 0.3, 0.9))},
    **{f"fused_{r}": (lambda i=i, r=r: _fused(_random_steps(30 + i, r)))
       for i, r in enumerate((0.0, 0.05, 0.3, 0.9))},
}
# the reference's CPU route adds pos + step in int32, which wraps for steps
# near INT32_MAX; those cases are held against the plain version only
NO_JAX = {"int32_max", "all_int32_max"}
SV = [(8, 0), (8, 4), (8, 16), (16, 0), (16, 4), (16, 16), (64, 0), (64, 4),
      (64, 16)]


@functools.lru_cache(maxsize=None)
def _case(kind: str):
    step = CASES[kind]()
    plain = tparse.parse_select(torch.from_numpy(step),
                                torch.from_numpy(BOUNDS)).numpy()
    if kind not in NO_JAX:
        ref = np.asarray(_ref(jnp.asarray(step), jnp.asarray(BOUNDS)))
        np.testing.assert_array_equal(plain, ref)
    return step, plain


@pytest.mark.parametrize("seg,lead", SV)
@pytest.mark.parametrize("kind", sorted(CASES))
def test_model_matches_plain_and_reference(kind, seg, lead):
    step, plain = _case(kind)
    got, _ = _model(step, BOUNDS, seg, lead)
    np.testing.assert_array_equal(got, plain)


@functools.lru_cache(maxsize=None)
def _real_steps():
    """Stage-1 steps of the port (lazy L6 rule) on real lanes, as in
    tests/test_torch_parse.py: raw, fused and their bounds."""
    lanes = torch.from_numpy(np.stack([
        np.frombuffer(sample(k, N, seed=2), np.uint8)
        for k in ("pigz", "text", "runs", "a4")]))
    B = lanes.shape[0]
    enc_end = torch.tensor([N, N - 100, 3000, N], dtype=torch.int32)
    core = tlz.lz77_lane(lanes, 1024, enc_end,
                         torch.zeros(B, dtype=torch.int32), 16, True, 32, 128,
                         unit=1024)
    bounds = torch.stack([torch.full((B,), 1024, dtype=torch.int32), enc_end],
                         1).numpy()
    raw = core["step"].numpy()
    return raw, _fused(raw), bounds


@pytest.mark.parametrize("seg,lead", SV)
@pytest.mark.parametrize("form", ["raw", "fused"])
def test_model_on_real_steps(form, seg, lead):
    raw, fused, bounds = _real_steps()
    step = raw if form == "raw" else fused
    ref = np.asarray(_ref(jnp.asarray(step), jnp.asarray(bounds)))
    plain = tparse.parse_select(torch.from_numpy(step),
                                torch.from_numpy(bounds)).numpy()
    np.testing.assert_array_equal(plain, ref)
    got, _ = _model(step, bounds, seg, lead)
    np.testing.assert_array_equal(got, ref)


def test_model_takes_every_branch():
    """The cases above reach each branch of the stitch: repairs that meet
    the speculative path, repairs that leave the segment, and clears. At
    the kernel's own SEG and LEAD the real lanes need no repair."""
    _, c = _model(_case("fused_0.05")[0], BOUNDS, 16, 0)
    assert c["repaired"] > c["merged"] > 0
    _, c = _model(_full(258), BOUNDS, 16, 0)
    assert c["cleared"] > 0
    _, c = _model(_full(3), BOUNDS, 64, 0)
    assert c["repaired"] > c["merged"] == 0
    raw, fused, bounds = _real_steps()
    for step in (raw, fused):
        _, c = _model(step, bounds, tparse.SEG, tparse.LEAD)
        assert c["repaired"] == c["cleared"] == 0


def test_wrapper_sizes_match_the_kernel():
    """ops/parse.py sizes the kernel's scratch by SEG, and the model above
    runs at SEG and LEAD: both must be csrc/parse.cu's constants."""
    src = (Path(tparse.__file__).resolve().parent.parent / "csrc"
           / "parse.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kSeg|kLead) = (\d+);", src))
    assert consts == {"kSeg": str(tparse.SEG), "kLead": str(tparse.LEAD)}


@functools.lru_cache(maxsize=None)
def _bit_steps():
    """Decode phase A's step array (`ops/inflate.py:_phase_a_steps`) of one
    wave at cb = 2048 (N = 16,384 bits): a dynamic block that ends in an
    EOB inside the lane (1 << 26, so the walk jumps to the end), a fixed
    block, an invalid code, fixed tables over random bytes, a lane whose
    block outruns it (no EOB), and the first lane again with its walk
    starting mid-segment, at a true token start."""
    import zlib as _zlib
    from zlibng_tpu_torch.ops import inflate as ti
    from zlibng_tpu_torch.stream.inflate_serial import RawInflater
    from torch_corpus import crafted_streams, raw_deflate
    rng = np.random.default_rng(8)
    lanes = [raw_deflate(sample("pigz", 4000)),
             raw_deflate(sample("text", 3000), strategy=_zlib.Z_FIXED),
             crafted_streams()["invalid literal/length code"],
             bytes([3]) + rng.integers(0, 256, 2047, np.uint8).tobytes(),
             raw_deflate(sample("pigz", 60000))]
    cb = 2048
    B = len(lanes) + 1
    comp = np.zeros(B * cb + cb, np.uint8)
    tabs = [np.zeros((B, 48 + 288), np.int32), np.zeros((B, 48 + 30),
                                                        np.int32)]
    starts = np.zeros(B, np.int32)
    bits = np.zeros(B, np.int32)
    masks = [np.zeros(B, np.int32), np.zeros(B, np.int32)]
    for i, raw in enumerate(lanes + lanes[:1]):
        inf = RawInflater()
        inf.feed(raw)
        _, lt, dt, (wl, wd), sym_bit = ti._parse_header(inf, ti._Cursor(0,
                                                                       None))
        piece = np.frombuffer(raw, np.uint8)[sym_bit >> 3:][:cb]
        comp[i * cb:i * cb + piece.size] = piece
        starts[i] = i * cb
        bits[i] = sym_bit & 7
        for t, m, tab, w in ((tabs[0], masks[0], lt, wl),
                             (tabs[1], masks[1], dt, wd)):
            t[i, :tab.size] = tab
            m[i] = (1 << w) - 1
    args = [torch.from_numpy(a) for a in (comp, starts, tabs[0], tabs[1],
                                          bits, masks[0], masks[1])]
    step, bounds, kind, _, _ = ti._phase_a_steps(*args, cb, 1 << 15,
                                                 1 << 15)
    step, bounds = step.numpy(), bounds.numpy().copy()
    # the last lane (lane 0 again) starts at its first true stop past 3000
    walk = tparse.parse_select(torch.from_numpy(step[:1]),
                               torch.from_numpy(bounds[:1])).numpy()[0]
    bounds[-1, 0] = int(np.nonzero(walk & (np.arange(walk.size) > 3000))[0][0])
    return step, bounds, kind.numpy()


def test_bit_steps_have_decode_traffic():
    step, bounds, kind = _bit_steps()
    plain = tparse.parse_select(torch.from_numpy(step),
                                torch.from_numpy(bounds)).numpy()
    ends = [int(kind[b][plain[b]][-1]) for b in range(step.shape[0])]
    # lanes 0, 1 and 5 end at an EOB, lane 2 at an invalid code, lane 4
    # runs out of the lane with no EOB
    assert ends[0] == ends[1] == ends[5] == 2 and ends[2] == 3
    assert not (kind[4][plain[4]] >= 2).any()
    assert set(np.unique(step).tolist()) <= set(range(1, 49)) | {BIG}
    assert bounds[-1, 0] % tparse.SEG != 0


@pytest.mark.parametrize("seg,lead", SV + [(tparse.SEG, tparse.LEAD)])
def test_model_on_bit_steps(seg, lead):
    step, bounds, _ = _bit_steps()
    ref = np.asarray(_ref(jnp.asarray(step), jnp.asarray(bounds)))
    plain = tparse.parse_select(torch.from_numpy(step),
                                torch.from_numpy(bounds)).numpy()
    np.testing.assert_array_equal(plain, ref)
    got, c = _model(step, bounds, seg, lead)
    np.testing.assert_array_equal(got, ref)
    # a walk that ends at an EOB or invalid code jumps to the lane's end:
    # every later segment whose lead-in walk guessed a stop is cleared
    assert c["cleared"] > 0
