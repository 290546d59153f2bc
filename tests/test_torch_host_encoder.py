"""The PyTorch port's host encoder (its copies of the JAX package's numpy
modules) against the originals, and the routing of compress_cuda to it.

Each carried module is held to its original: `find_matches` and
`lazy_parse`, `huffman_table` and `build_dynamic_header` (the original
uses its C build where present; the port carries the numpy path), the
length/distance code tables, `token_bits` and `compress_bound`. Then
compress_cuda(device="cpu") must give compress_tpu's bytes at levels 0-9
x strategies 0-4 on 0, 1, 100 and 1023 bytes, and at level 0 on 40,000
bytes. Tolerance: none.
"""
import os
import zlib

import numpy as np
import pytest

from zlibng_tpu.format import constants as RC
from zlibng_tpu.huffman import bitpack as rbitpack
from zlibng_tpu.huffman import encode as renc
from zlibng_tpu.lz77 import engine as reng
from zlibng_tpu.ops.deflate_tpu import compress_tpu
from zlibng_tpu.stream import deflate as rdef
from zlibng_tpu_torch import compress_cuda
from zlibng_tpu_torch.format import constants as TC
from zlibng_tpu_torch.huffman import bitpack as tbitpack
from zlibng_tpu_torch.huffman import encode as tenc
from zlibng_tpu_torch.lz77 import engine as teng
from zlibng_tpu_torch.ops import parse, probe
from zlibng_tpu_torch.stream import deflate as tdef

from torch_corpus import FIXTURES, sample

CONFIGS = [reng.MatchConfig(chain=2, lazy=False, max_lazy=4, nice=16),
           reng.MatchConfig(chain=16, lazy=True, max_lazy=32, nice=128),
           reng.MatchConfig(chain=64, lazy=True, max_lazy=258, nice=258)]


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
@pytest.mark.parametrize("corpus", ["pigz", "text", "runs", "a4"])
def test_find_matches_and_lazy_parse_match_reference(corpus, cfg):
    rc = CONFIGS[cfg]
    tc = teng.MatchConfig(chain=rc.chain, lazy=rc.lazy,
                          max_lazy=rc.max_lazy, nice=rc.nice)
    lane = np.frombuffer(sample(corpus, 12000, seed=cfg), np.uint8)
    for es, ee, window in ((0, 12000, 32768), (3000, 11000, 512)):
        want = reng.find_matches(lane, es, ee, rc, window=window)
        got = teng.find_matches(lane, es, ee, tc, window=window)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(teng.lazy_parse(*got, es, ee, tc),
                        reng.lazy_parse(*want, es, ee, rc)):
            np.testing.assert_array_equal(g, w)


def _freq_cases():
    rng = np.random.default_rng(3)
    cases = [np.zeros(286, np.int64), np.eye(286, dtype=np.int64)[65],
             np.eye(30, dtype=np.int64)[0] * 7,
             rng.integers(0, 50, 286), rng.integers(0, 3, 30),
             (2.0 ** np.arange(30)).astype(np.int64),         # deep tree
             np.load(os.path.join(FIXTURES, "oversub_freq.npy"))]
    cases += [rng.geometric(0.05, 286) * (rng.random(286) < 0.5)
              for _ in range(5)]
    return cases


@pytest.mark.parametrize("i", range(len(_freq_cases())))
def test_huffman_table_and_header_match_reference(i):
    f = _freq_cases()[i]
    for got, want in zip(tenc.huffman_table(f, 15), renc.huffman_table(f, 15)):
        np.testing.assert_array_equal(np.asarray(got, np.int64),
                                      np.asarray(want, np.int64))
    lens, _ = tenc.huffman_table(f, 15)
    assert int((2.0 ** -lens[lens > 0]).sum() * 2 ** 15) <= 2 ** 15
    if f.size == 286:
        dl, _ = tenc.huffman_table(np.arange(30) % 4, 15)
        ll = np.concatenate([lens, [0, 0]])
        assert tenc.build_dynamic_header(ll, dl) \
            == renc.build_dynamic_header(ll, dl)


def test_code_tables_token_bits_and_bound_match_reference():
    np.testing.assert_array_equal(TC.LENGTH_CODE_LUT, RC.LENGTH_CODE_LUT)
    np.testing.assert_array_equal(TC.DIST_CODE_LUT, RC.DIST_CODE_LUT)
    d = np.arange(1, 32769)
    np.testing.assert_array_equal(TC.dist_to_code(d), RC.dist_to_code(d))
    ln = np.arange(3, 259)
    np.testing.assert_array_equal(TC.length_to_code(ln),
                                  RC.length_to_code(ln))
    rng = np.random.default_rng(5)
    T = 4000
    sel_len = np.where(rng.random(T) < 0.4, rng.integers(3, 259, T), 0)
    sel_val = rng.integers(0, 256, T)
    sel_dist = np.where(sel_len > 0, rng.integers(1, 32769, T), 0)
    lens, codes = tenc.huffman_table(rng.integers(1, 100, 288), 15)
    dlens, dcodes = tenc.huffman_table(rng.integers(1, 100, 30), 15)
    args = (sel_len, sel_val, sel_dist, lens, codes, dlens, dcodes)
    for g, w in zip(tbitpack.token_bits(*args), rbitpack.token_bits(*args)):
        np.testing.assert_array_equal(g, w)
    for n in (0, 1, 1023, 65536, 10 ** 7):
        for wbits in (-15, 15, 31):
            for level in (None, 0, 1, 9):
                assert tdef.compress_bound(n, wbits, level, True) \
                    == rdef.compress_bound(n, wbits, level, True)


def test_detect_data_type_matches_reference():
    rng = np.random.default_rng(9)
    for f in (np.zeros(256, int), np.bincount(np.frombuffer(
            sample("text", 5000), np.uint8), minlength=256),
            rng.integers(0, 3, 256), np.eye(256, dtype=int)[7]):
        assert tdef.detect_data_type(f) == rdef.detect_data_type(f)


@pytest.mark.parametrize("n", [0, 1, 100, 1023])
@pytest.mark.parametrize("strategy", range(5))
@pytest.mark.parametrize("level", range(10))
def test_small_inputs_byte_identical(level, strategy, n):
    data = sample("pigz", n, seed=level)
    before = (probe.launches, parse.launches)
    got = compress_cuda(data, level, strategy=strategy, device="cpu")
    assert got == compress_tpu(data, level, strategy=strategy)
    assert zlib.decompress(got) == data
    assert (probe.launches, parse.launches) == before


@pytest.mark.parametrize("wbits", [-15, 15, 31])
def test_level0_byte_identical(wbits):
    data = sample("text", 40000)
    got = compress_cuda(data, 0, wbits=wbits, device="cpu")
    assert got == compress_tpu(data, 0, wbits=wbits)
    d = zlib.decompressobj(wbits)
    assert d.decompress(got) + d.flush() == data


def test_small_input_with_dictionary_byte_identical():
    zdict = sample("text", 3000, seed=1)
    data = sample("text", 900)
    for level, strategy in ((1, 0), (6, 0), (6, 4), (9, 3)):
        got = compress_cuda(data, level, strategy=strategy,
                            dictionary=zdict, device="cpu")
        assert got == compress_tpu(data, level, strategy=strategy,
                                   dictionary=zdict)
        d = zlib.decompressobj(zdict=zdict)
        assert d.decompress(got) + d.flush() == data
