"""The fixed-tree quick path of the PyTorch port (L1 with the default
strategy, Z_FIXED at any level) against the JAX package, around its
arguments: compress_cuda(device="cpu") must give compress_tpu's bytes,
which stdlib zlib decodes, at several windowBits, with a dictionary, over
several lane groups, and at the levels that route around the quick path
(-1, 10, L1 with strategies 1-3). Tolerance: none.
"""
import zlib

import pytest

from zlibng_tpu.ops.deflate_tpu import compress_tpu
from zlibng_tpu_torch import compress_cuda
from zlibng_tpu_torch.ops import deflate as tdef

from torch_corpus import pigz, sample

N = 40000
QUICK = [(1, 0), (6, 4)]          # (level, strategy) of the two quick kinds


def _same(data, **kw):
    want = compress_tpu(data, **kw)
    got = compress_cuda(data, device="cpu", **kw)
    assert got == want
    return got


@pytest.mark.parametrize("wbits", [-15, -9, 15, 31])
@pytest.mark.parametrize("level,strategy", QUICK)
def test_quick_wbits_byte_identical(level, strategy, wbits):
    data = sample("text", N)
    got = _same(data, level=level, strategy=strategy, wbits=wbits)
    d = zlib.decompressobj(wbits)
    assert d.decompress(got) + d.flush() == data


@pytest.mark.parametrize("level,strategy", QUICK)
def test_quick_dictionary_byte_identical(level, strategy):
    zdict = sample("pigz", 20000, seed=3)
    data = sample("pigz", N)
    got = _same(data, level=level, strategy=strategy, dictionary=zdict)
    d = zlib.decompressobj(zdict=zdict)
    assert d.decompress(got) + d.flush() == data


@pytest.mark.parametrize("level,strategy", QUICK)
def test_quick_lane_groups_byte_identical(level, strategy, monkeypatch):
    """Three lanes of 128 KiB, the last one ending in random bytes
    (stored units at the stream's end), in one group for the reference
    and in groups of one lane for the port."""
    data = pigz()[:280000] + sample("a256", 20000, seed=5)
    want = compress_tpu(data, level, strategy=strategy)
    monkeypatch.setattr(tdef, "GROUP_BYTES", 1 << 17)
    got = compress_cuda(data, level, strategy=strategy, device="cpu")
    assert got == want
    assert zlib.decompress(got) == data


@pytest.mark.parametrize("level,strategy", [(-1, 0), (10, 0), (1, 1),
                                            (1, 2), (1, 3)])
def test_auto_path_levels_byte_identical(level, strategy):
    """Level -1 (L1's engine, the auto stage 2, FLEVEL 0), level 10 (L9's
    engine) and L1 with strategies 1-3 go through the auto stage 2."""
    data = sample("text", N)
    assert zlib.decompress(_same(data, level=level, strategy=strategy)) \
        == data
