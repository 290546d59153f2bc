"""Whole-stream decode of the port, `decompress_cuda(device="cpu")`,
against the JAX package's `decompress_tpu` and stdlib zlib: framings,
dictionaries, small windows, many-block history and the port's own
streams. Outputs and `stats` deltas must be equal, and no valid stream may
fall back to the serial decoder on either side (the reference's runs its
numpy path, `_native_lib = False`, which the port carries). Stdlib zlib's
levels are in test_torch_inflate_levels.py; corrupt streams and the host
route in test_torch_inflate_errors.py.

Streams stay under 16 KiB compressed, so phase A's lanes stay at cb <= 16384.
"""
import gzip
import zlib

import pytest

import zlibng_tpu.stream.inflate_serial as ref_ser
from zlibng_tpu.errors import DataError as RefDataError
from zlibng_tpu.ops import inflate_tpu as itpu
from zlibng_tpu_torch import compress_cuda, decompress_cuda
from zlibng_tpu_torch.errors import DataError
from zlibng_tpu_torch.ops import inflate as ti
from zlibng_tpu_torch.stream import inflate_serial as tser

from torch_corpus import pigz, raw_deflate, sample


@pytest.fixture(autouse=True)
def ref_numpy_path(monkeypatch):
    monkeypatch.setattr(ref_ser, "_native_lib", False)


@pytest.fixture
def no_serial_fallback(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("device decode fell back to serial")
    monkeypatch.setattr(tser, "inflate_raw", boom)
    monkeypatch.setattr(ref_ser, "inflate_raw", boom)


def _both(stream, **kw):
    """(output or error text, stats delta) of the port and the reference."""
    out = []
    for fn, stats, err in ((lambda: decompress_cuda(stream, device="cpu",
                                                    **kw), ti.stats,
                            DataError),
                           (lambda: itpu.decompress_tpu(stream, **kw),
                            itpu.stats, RefDataError)):
        before = dict(stats)
        try:
            got = bytes(fn())
        except err as e:
            got = f"error: {e}"
        out.append((got, {k: stats[k] - before[k] for k in before}))
    return out


def _framings():
    data = pigz()[:20000]
    dct = sample("text", 3000) + pigz()[100000:120000]
    return {
        "gzip 31": (gzip.compress(data), dict(wbits=31), data),
        "gzip auto 47": (gzip.compress(data), dict(wbits=47), data),
        "zlib auto 47": (zlib.compress(data), dict(wbits=47), data),
        "raw -15": (raw_deflate(data), dict(wbits=-15), data),
        "raw -9": (raw_deflate(data, wbits=-9), dict(wbits=-9), data),
        "zlib wbits 9": (raw_deflate(data, wbits=9), {}, data),
        "zlib dictionary": (raw_deflate(data, wbits=15, zdict=dct),
                            dict(dictionary=dct), data),
        "raw dictionary": (raw_deflate(data, zdict=dct), dict(wbits=-15,
                                                      dictionary=dct), data),
        # zlib's 512-symbol blocks (memLevel 3): matches reach back
        # across many block boundaries
        "many blocks": (raw_deflate(pigz()[:12000] * 2, mem=3, wbits=15), {},
                        pigz()[:12000] * 2),
        "fixed": (raw_deflate(data, strategy=zlib.Z_FIXED, wbits=15), {},
                  data),
        "port L6": (compress_cuda(data, 6, device="cpu"), {}, data),
        "port L1": (compress_cuda(data, 1, device="cpu"), {}, data),
        "port gzip L9": (compress_cuda(data, 9, wbits=31, device="cpu"),
                         dict(wbits=31), data),
    }


FRAMINGS = _framings()


@pytest.mark.parametrize("name", sorted(FRAMINGS))
def test_framings_and_options_match_reference(name, no_serial_fallback):
    stream, kw, data = FRAMINGS[name]
    port, ref = _both(stream, **kw)
    assert port == ref and port[0] == data
    assert port[1]["device_ok"] == 1


def test_dictionary_through_inflate_raw(no_serial_fallback):
    stream, kw, data = FRAMINGS["raw dictionary"]
    got = ti.inflate_raw_cuda(stream, 15, dictionary=kw["dictionary"],
                              device="cpu")
    want = itpu.inflate_raw_tpu(stream, 15, dictionary=kw["dictionary"])
    assert got[0] == data and got == (want[0], want[1])
