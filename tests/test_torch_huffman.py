"""Huffman tables and dynamic headers of the PyTorch port against the JAX
package and the host builder.

`huff_table` must give lengths and LSB-first codes bit-identical to
`huffman_jax.huff_table` and to `huffman/encode.py`, on adversarial and
random frequency sets (including the oversubscribed fixture that needs the
Kraft restore), batched over rows. `dyn_header` must give the reference's
fixed-slot token arrays and the host builder's token stream. Tolerance:
none.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zlibng_tpu.format.constants import canonical_codes, reverse_bits
from zlibng_tpu.huffman.encode import (
    build_dynamic_header, huffman_code_lengths,
)
from zlibng_tpu.ops.huffman_jax import dyn_header as ref_dyn_header
from zlibng_tpu.ops.huffman_jax import huff_table as ref_huff_table
from zlibng_tpu_torch.ops.huffman import dyn_header, huff_table

from torch_corpus import FIXTURES


def _freq_cases(n: int, seed: int):
    """The generator of tests/test_huffman_jax.py, for alphabet size n."""
    rng = np.random.default_rng(seed)
    z = np.zeros(n, np.int64)
    cases = [z.copy()]
    o = z.copy(); o[min(65, n - 1)] = 7; cases.append(o)
    t = z.copy(); t[1] = 1; t[2] = 1; cases.append(t)
    cases.append(np.full(n, 3, np.int64))
    fib = z.copy()
    a, b = 1, 1
    for i in range(min(25, n)):
        fib[i] = a
        a, b = b, a + b
    cases.append(fib)
    pw = z.copy()
    for i in range(min(20, n)):
        pw[i] = 1 << i                           # forces >15-bit overflow
    cases.append(pw)
    for _ in range(60):
        k = rng.integers(1, n)
        f = np.zeros(n, np.int64)
        f[rng.choice(n, k, replace=False)] = rng.integers(1, 10000, k)
        cases.append(f)
    for _ in range(30):
        cases.append(rng.poisson(5, n).astype(np.int64))
    for _ in range(30):
        f = (10000 / (1 + np.arange(n)) ** rng.uniform(0.5, 2.0))
        f = f.astype(np.int64)
        rng.shuffle(f)
        cases.append(f)
    if n == 286:
        cases.append(np.load(f"{FIXTURES}/oversub_freq.npy"))
    return np.stack(cases).astype(np.int32)


@pytest.mark.parametrize("n,max_bits", [(286, 15), (30, 15), (19, 7)])
def test_huff_table_matches_reference_and_host(n, max_bits):
    F = _freq_cases(n, seed=n)
    lens, codes = huff_table(torch.from_numpy(F), max_bits)
    ref = jax.jit(jax.vmap(functools.partial(ref_huff_table,
                                             max_bits=max_bits)))
    rl, rc = ref(jnp.asarray(F))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
    for f, ln, cd in zip(F, lens.numpy(), codes.numpy()):
        hl = huffman_code_lengths(f.astype(np.int64), max_bits)
        np.testing.assert_array_equal(ln, hl)
        np.testing.assert_array_equal(
            cd, reverse_bits(canonical_codes(hl, max_bits), hl, max_bits))


def _bits(pairs):
    out = []
    for v, nb in pairs:
        out.extend((int(v) >> k) & 1 for k in range(int(nb)))
    return out


def test_dyn_header_matches_reference_and_host():
    rng = np.random.default_rng(7)
    lit, dist = [], []
    for _ in range(60):
        lf = rng.poisson(rng.uniform(0.2, 30), 286).astype(np.int64)
        lf[256] = max(lf[256], 1)
        df = rng.poisson(rng.uniform(0.0, 10), 30).astype(np.int64)
        lit.append(lf)
        dist.append(df)
    for _ in range(30):                          # long zero runs inside
        lf = np.zeros(286, np.int64)
        lf[rng.choice(286, rng.integers(2, 20), replace=False)] = \
            rng.integers(1, 500)
        lf[256] = 1
        df = np.zeros(30, np.int64)
        df[rng.choice(30, rng.integers(0, 5), replace=False)] = 2
        lit.append(lf)
        dist.append(df)
    lf = np.zeros(286, np.int64); lf[256] = 1; lf[65] = 5
    lit += [lf, lf]
    df1 = np.zeros(30, np.int64); df1[0] = 3
    dist += [np.zeros(30, np.int64), df1]        # no / one dist code
    ll = np.stack([huffman_code_lengths(f, 15) for f in lit]).astype(np.int32)
    dl = np.stack([huffman_code_lengths(f, 15) for f in dist]).astype(np.int32)

    lo, nb, tot = dyn_header(torch.from_numpy(ll), torch.from_numpy(dl), 4)
    ref = jax.jit(jax.vmap(lambda a, b: ref_dyn_header(a, b, jnp.int32(4))))
    rlo, rnb, rtot = ref(jnp.asarray(np.pad(ll, ((0, 0), (0, 2)))),
                         jnp.asarray(dl))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo).astype(np.int64))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(rnb))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(rtot))
    for i in range(ll.shape[0]):
        toks, hbits = build_dynamic_header(ll[i], dl[i])
        assert int(tot[i]) - 3 == hbits
        assert _bits(zip(lo[i].tolist(), nb[i].tolist()))[3:] == _bits(toks)
