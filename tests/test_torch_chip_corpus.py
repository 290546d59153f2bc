"""chip_smoke.py's corpus, and the reference's output on it.

chip_smoke.py holds the card's L6, L9, L1 and Z_FIXED streams of its
8.5 MiB corpus to the digests in its `STREAMS` table. The corpus is drawn
with integer arithmetic only, so its digest is fixed on every machine
(checked here); the slow test computes the reference's (compress_tpu, JAX
on the CPU) streams of it, which must equal the table, and the port's CPU
streams. The slow tests take several minutes, so the regular run leaves
them out. The chain-128 group of the deep-probe phase is held to the
reference's digest (`DEEP_STREAM`) as well: the port's CPU stream of it in
the regular run, at the card's size (28 chunks of deep probes), and the
reference's in the slow one."""
from types import SimpleNamespace

import hashlib

import pytest

import chip_smoke

CORPUS_SHA256 = "e378c3ae84ae46ed"


def _digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:16]


def test_corpus_is_the_same_everywhere():
    data, parts = chip_smoke.corpus()
    assert len(data) == 8_912_896 == sum(n for _, n in parts)
    assert _digest(data) == CORPUS_SHA256


@pytest.mark.slow
@pytest.mark.parametrize("level,strategy", sorted(chip_smoke.STREAMS))
def test_reference_and_port_streams_of_the_corpus(level, strategy):
    from zlibng_tpu.ops.deflate_tpu import compress_tpu
    from zlibng_tpu_torch import compress_cuda
    data, _ = chip_smoke.corpus()
    want = compress_tpu(data, level, strategy=strategy)
    assert (len(want), _digest(want)) == chip_smoke.STREAMS[level, strategy]
    assert compress_cuda(data, level, strategy=strategy, device="cpu") == want


def test_port_deep_stream_of_the_corpus():
    from zlibng_tpu_torch import compress_cuda
    from zlibng_tpu_torch.ops import lz77
    group = chip_smoke.corpus()[0][: 2 << 20]
    lz77.deep_stats.update(rows=0, chunks=0)
    out = compress_cuda(group, 6, tune=SimpleNamespace(**chip_smoke.DEEP_TUNE),
                        device="cpu")
    assert (len(out), _digest(out)) == chip_smoke.DEEP_STREAM
    assert lz77.deep_stats["chunks"] > 1


@pytest.mark.slow
def test_reference_deep_stream_of_the_corpus():
    from zlibng_tpu.ops.deflate_tpu import compress_tpu
    from zlibng_tpu.stream.deflate import LevelConfig
    group = chip_smoke.corpus()[0][: 2 << 20]
    want = compress_tpu(group, 6, tune=LevelConfig(**chip_smoke.DEEP_TUNE))
    assert (len(want), _digest(want)) == chip_smoke.DEEP_STREAM
