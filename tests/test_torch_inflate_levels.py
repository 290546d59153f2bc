"""Whole-stream decode of stdlib zlib's levels 0, 1, 6 and 9 by the port,
`decompress_cuda(device="cpu")`, against the JAX package's
`decompress_tpu` and the input: outputs and `stats` deltas equal, and no
serial fallback on either side (the reference's numpy path,
`_native_lib = False`)."""
import zlib

import pytest

import zlibng_tpu.stream.inflate_serial as ref_ser
from zlibng_tpu.ops import inflate_tpu as itpu
from zlibng_tpu_torch import decompress_cuda
from zlibng_tpu_torch.ops import inflate as ti
from zlibng_tpu_torch.stream import inflate_serial as tser

from torch_corpus import pigz, sample

CORPORA = {"pigz": lambda: pigz()[:20000],
           "runs": lambda: sample("runs", 20000),
           "a16": lambda: sample("a16", 8000),
           "zeros": lambda: bytes(100000), "tiny": lambda: b"hello",
           "empty": lambda: b""}


@pytest.fixture(autouse=True)
def no_serial_fallback(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("device decode fell back to serial")
    monkeypatch.setattr(ref_ser, "_native_lib", False)
    monkeypatch.setattr(tser, "inflate_raw", boom)
    monkeypatch.setattr(ref_ser, "inflate_raw", boom)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_levels_match_reference_and_zlib(name, level):
    data = CORPORA[name]()
    c = zlib.compress(data, level)
    deltas = []
    for fn, stats in ((lambda: decompress_cuda(c, device="cpu"), ti.stats),
                      (lambda: itpu.decompress_tpu(c), itpu.stats)):
        before = dict(stats)
        assert bytes(fn()) == data
        deltas.append({k: stats[k] - before[k] for k in before})
    assert deltas[0] == deltas[1] == {"device_ok": 1, "fallback": 0,
                                      "host_routed": 0, "mesh_ok": 0,
                                      "error": 0}
