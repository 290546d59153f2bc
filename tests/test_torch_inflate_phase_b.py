"""Decode phase B of the port (`ops/inflate.py:_phase_b_multi`) against
the JAX package's (`ops/inflate_tpu.py:_phase_b_multi`): literal, match
and stored-run tokens, a preset dictionary, overlapping copies, distances
reaching before the dictionary or past the window (`bad`), and the token
arrays of real decodes. Outputs and flags equal: tolerance none."""
import functools
import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zlibng_tpu.ops import inflate_tpu as itpu
from zlibng_tpu_torch.ops import inflate as ti

from torch_corpus import pigz, sample

L, M, S = ti.B_LIT, ti.B_MATCH, ti.B_STORED


def _pack(segs, T=64):
    """(kinds, auxs, olens) (len(segs), T) int32 from lists of tokens."""
    out = [np.zeros((len(segs), T), np.int32) for _ in range(3)]
    for i, toks in enumerate(segs):
        for j, tok in enumerate(toks):
            for a, v in zip(out, tok):
                a[i, j] = v
    return out


def _hand_case():
    comp = np.frombuffer(sample("pigz", 4096), np.uint8).copy()
    dct = np.frombuffer(sample("text", 1000), np.uint8)
    dictv = np.zeros(1 << 15, np.uint8)
    dictv[-len(dct):] = dct
    segs = [
        # dictionary segment: literals, a copy from the dictionary, a
        # stored run, overlapping copies (dist 1 and 3), a long copy
        [(L, 65, 1), (L, 66, 1), (M, 900, 40), (S, 100, 300), (M, 1, 258),
         (L, 67, 1), (M, 3, 100), (M, 600, 258), (S, 0, 17)],
        # no dictionary: a copy from before the data sets `bad`
        [(L, 1, 1), (L, 2, 1), (M, 5, 10), (L, 3, 1)],
        # no dictionary, in range: runs of overlapping copies only
        [(L, 9, 1), (M, 1, 258), (M, 1, 258), (L, 8, 1), (M, 2, 77)],
        # an empty segment (all tokens olen 0)
        [],
    ]
    kinds, auxs, olens = _pack(segs)
    dlens = np.array([len(dct), 0, 0, 0], np.int32)
    return kinds, auxs, olens, comp, dictv, dlens


def _run_both(kinds, auxs, olens, comp, dictv, dlens, wsize, out_cap):
    got = ti._phase_b_multi(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in (kinds, auxs, olens, comp, dictv,
                                        dlens)), wsize, out_cap)
    want = itpu._phase_b_multi(*(jnp.asarray(a) for a in (
        kinds, auxs, olens, comp, dictv, dlens)), jnp.int32(wsize), out_cap)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("wsize", [1 << 15, 512])
def test_hand_made_tokens_match_reference(wsize):
    kinds, auxs, olens, comp, dictv, dlens = _hand_case()
    (out, bad), (ref_out, ref_bad) = _run_both(
        kinds, auxs, olens, comp, dictv, dlens, wsize, 1 << 16)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(bad, ref_bad)
    assert out.dtype == np.uint8 and bad.dtype == np.bool_
    # segment 1 copies from before its data; at wsize 512 the dictionary
    # segment's 900-byte distance is past the window too
    assert bad.tolist() == [wsize == 512, True, False, False]


@functools.lru_cache(maxsize=None)
def _captured(name: str):
    """Phase B's inputs in a real decode of the port (device="cpu")."""
    dct = sample("text", 20000) if name == "pigz" else None
    # (level, strategy, bytes) pieces, joined at sync flushes: "mixed" is a
    # fixed-tree, a stored and a dynamic piece
    pieces = {"pigz": [(6, 0, pigz()[:50000])],
              "runs": [(6, 0, sample("runs", 60000))],
              "mixed": [(6, zlib.Z_FIXED, pigz()[:8000]),
                        (0, 0, sample("a256", 3000)),
                        (6, 0, pigz()[:20000])]}[name]
    raw = b""
    for i, (level, strategy, piece) in enumerate(pieces):
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy,
                              **({"zdict": dct} if dct else {}))
        raw += co.compress(piece) + co.flush(
            zlib.Z_FINISH if i == len(pieces) - 1 else zlib.Z_SYNC_FLUSH)
    data = b"".join(p for _, _, p in pieces)
    seen = []

    def capture(*args):
        seen.append(args)
        return ti._phase_b_default(*args)

    outs, _ = ti._decode_segments(raw, [(0, None)], dct, 1 << 15,
                                  phase_b_fn=capture, device="cpu")
    assert outs[0] == data
    kinds, auxs, olens, comp_j, dictv_j, dlens, wsize, out_cap = seen[0]
    return (kinds, auxs, olens, comp_j.numpy(), dictv_j.numpy(), dlens,
            wsize, out_cap)


@pytest.mark.parametrize("name", ["pigz", "runs", "mixed"])
def test_real_tokens_match_reference(name):
    args = _captured(name)
    (out, bad), (ref_out, ref_bad) = _run_both(*args)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(bad, ref_bad)
    assert not bad.any()
