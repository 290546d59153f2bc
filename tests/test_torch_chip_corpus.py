"""chip_smoke.py's corpus, and the reference's output on it.

chip_smoke.py prints the digests of the card's L6 and L9 streams of its
8.5 MiB corpus. The corpus is drawn with integer arithmetic only, so its
digest is fixed on every machine (checked here); the slow test computes
the reference's (compress_tpu, JAX on the CPU) streams of it, which the
card's must equal, and the port's CPU streams. The slow test takes about
two minutes, so the regular run leaves it out."""
import hashlib

import pytest

import chip_smoke

CORPUS_SHA256 = "e378c3ae84ae46ed"
STREAMS = {6: (3703261, "b2e5193bf13fdc9f"), 9: (3680619, "edbde05b1a5bf4d1")}


def _digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:16]


def test_corpus_is_the_same_everywhere():
    data, parts = chip_smoke.corpus()
    assert len(data) == 8_912_896 == sum(n for _, n in parts)
    assert _digest(data) == CORPUS_SHA256


@pytest.mark.slow
@pytest.mark.parametrize("level", [6, 9])
def test_reference_and_port_streams_of_the_corpus(level):
    from zlibng_tpu.ops.deflate_tpu import compress_tpu
    from zlibng_tpu_torch import compress_cuda
    data, _ = chip_smoke.corpus()
    want = compress_tpu(data, level)
    assert (len(want), _digest(want)) == STREAMS[level]
    assert compress_cuda(data, level, device="cpu") == want
