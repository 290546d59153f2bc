"""Decode of corrupt, truncated and bad-trailer streams, the host route
and the serial fallback of the port, `decompress_cuda(device="cpu")`,
against the JAX package's `decompress_tpu`: error strings, outputs and
`stats` deltas must be equal. The reference's serial fallback
runs its numpy path (`_native_lib = False`), which the port carries; the
device path reruns a stream there for zlib's exact error text.
"""
import gzip
import zlib

import numpy as np
import pytest

import zlibng_tpu.stream.inflate_serial as ref_ser
from zlibng_tpu.errors import DataError as RefDataError
from zlibng_tpu.ops import inflate_tpu as itpu
from zlibng_tpu_torch import decompress_cuda
from zlibng_tpu_torch.errors import DataError
from zlibng_tpu_torch.ops import inflate as ti

from torch_corpus import crafted_streams, pigz, raw_deflate, sample


@pytest.fixture(autouse=True)
def ref_numpy_path(monkeypatch):
    monkeypatch.setattr(ref_ser, "_native_lib", False)


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


def _corrupt():
    base = zlib.compress(pigz()[:20000], 6)
    gz = gzip.compress(pigz()[:8000])
    dct = sample("text", 2000)
    with_dict = raw_deflate(pigz()[:8000], wbits=15, zdict=dct)
    cases = {}
    for flip in (2, 30, 300, 1000, len(base) - 6, len(base) - 1):
        c = bytearray(base)
        c[flip] ^= 0xFF
        cases[f"zlib, byte {flip} flipped"] = (bytes(c), {})
    rng = np.random.default_rng(4)
    for i, pos in enumerate(rng.integers(2, 200, 6)):
        c = bytearray(base)
        c[pos] ^= int(rng.integers(1, 256))
        cases[f"zlib, header byte {pos} changed"] = (bytes(c), {})
    for name, raw in crafted_streams().items():
        cases[f"raw, {name}"] = (raw, dict(wbits=-15))
    cases["truncated to 100 B"] = (base[:100], {})
    cases["truncated trailer"] = (base[:-2], {})
    cases["truncated header"] = (base[:1], {})
    cases["gzip, bad crc"] = (gz[:-8] + bytes([gz[-8] ^ 1]) + gz[-7:],
                              dict(wbits=31))
    cases["gzip, bad length"] = (gz[:-4] + bytes([gz[-4] ^ 1]) + gz[-3:],
                                 dict(wbits=31))
    cases["gzip, bad magic"] = (b"\x1f\x8c" + gz[2:], dict(wbits=31))
    cases["dictionary needed"] = (with_dict, {})
    cases["wrong dictionary"] = (with_dict, dict(dictionary=b"x" * 100))
    return cases


CORRUPT = _corrupt()


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_corrupt_streams_match_reference(name):
    stream, kw = CORRUPT[name]
    port, ref = _both(stream, **kw)
    assert port == ref
    if name.startswith(("raw, ", "truncated", "gzip, bad", "dict",
                        "wrong")):
        assert port[0].startswith("error: ")


def test_bad_trailer_raises_data_check():
    c = bytearray(zlib.compress(pigz()[:20000], 6))
    c[-1] ^= 0xFF
    with pytest.raises(DataError, match="incorrect data check"):
        decompress_cuda(bytes(c), device="cpu")


@pytest.mark.parametrize("engine", ["host", "auto, over the single max"])
def test_host_route_matches_reference(monkeypatch, engine):
    data = pigz()[:20000]
    c = zlib.compress(data, 6)
    kw = {"engine": "host"}
    if engine != "host":
        monkeypatch.setattr(ti, "_DEVICE_SINGLE_MAX", 1000)
        monkeypatch.setattr(itpu, "_DEVICE_SINGLE_MAX", 1000)
        kw = {}
    port, ref = _both(c, **kw)
    assert port == ref == (data, {"device_ok": 0, "fallback": 0,
                                  "host_routed": 1, "mesh_ok": 0,
                                  "error": 0})


def test_token_saturation_falls_back():
    """More tokens than T_CAP = N / 4 in the stream's largest lane reruns
    the stream serially, as in the reference: 20,001 one-bit literals
    (Z_HUFFMAN_ONLY) are a 2.5 KB stream, so the lane is cb = 4096 bytes
    and holds at most 8192 tokens."""
    data = b"a" * 20000 + b"b"
    c = raw_deflate(data, wbits=15, strategy=zlib.Z_HUFFMAN_ONLY)
    port, ref = _both(c)
    assert port == ref == (data, {"device_ok": 0, "fallback": 1,
                                  "host_routed": 0, "mesh_ok": 0,
                                  "error": 0})
