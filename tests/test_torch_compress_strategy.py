"""compress_cuda (PyTorch port, device="cpu") against compress_tpu for
strategies 1-3 (filtered, huffman-only, rle), a lazy mid level and a
deflateTune setting with chain <= 64: byte-identical streams that stdlib
zlib decodes."""
import zlib

import pytest

from zlibng_tpu.ops.deflate_tpu import compress_tpu
from zlibng_tpu.stream.deflate import LevelConfig as RefLevelConfig
from zlibng_tpu_torch import compress_cuda

from torch_corpus import sample

N = 40000


@pytest.mark.parametrize("strategy", [1, 2, 3])
def test_strategies_byte_identical(strategy):
    data = sample("pigz", N)
    want = compress_tpu(data, 6, strategy=strategy)
    got = compress_cuda(data, 6, strategy=strategy, device="cpu")
    assert got == want
    assert zlib.decompress(got) == data


@pytest.mark.parametrize("level,tune", [
    (4, None),
    (6, RefLevelConfig(24, True, 40, 200, good=10)),
])
def test_level4_and_tune_byte_identical(level, tune):
    data = sample("text", N)
    want = compress_tpu(data, level, tune=tune)
    got = compress_cuda(data, level, tune=tune, device="cpu")
    assert got == want
    assert zlib.decompress(got) == data
