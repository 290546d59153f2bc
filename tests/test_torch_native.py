"""The port's host runtime (`zlibng_tpu_torch/native/`, C built at first
use) and the routes that take it: checksums, the host Huffman builds, the
decode LUT fill and the serial decoder. Each is run on both routes of both
packages (the C host runtime, and numpy with `native._lib = False` and
`inflate_serial._native_lib = False`) on the same inputs, and all four
results must be equal: arrays, bytes, bit positions, error text, `stats`
moves and return types (the C one-shot decode returns a zero-copy
memoryview). The 32 corrupt streams of test_torch_inflate_errors.py give
the same text on every route: the C runtime words no error differently."""
import contextlib
import gc
import sys
import zlib

import numpy as np
import pytest

import zlibng_tpu.stream.inflate_serial as rser
from zlibng_tpu import native as rnative
from zlibng_tpu.errors import DataError as RefDataError
from zlibng_tpu.huffman import decode_tables as rdt
from zlibng_tpu.huffman import encode as renc
from zlibng_tpu.ops import inflate_tpu as itpu
from zlibng_tpu_torch import decompress_cuda
from zlibng_tpu_torch import native as tnative
from zlibng_tpu_torch.checksum.adler32 import adler32
from zlibng_tpu_torch.checksum.crc32 import crc32
from zlibng_tpu_torch.errors import DataError
from zlibng_tpu_torch.huffman import decode_tables as tdt
from zlibng_tpu_torch.huffman import encode as tenc
from zlibng_tpu_torch.ops import inflate as ti
from zlibng_tpu_torch.stream import inflate_serial as tser

from test_torch_inflate_errors import CORRUPT
from torch_corpus import pigz, raw_deflate, sample


@pytest.fixture(autouse=True)
def c_runtime():
    if not (tnative.available() and rnative.available()):
        pytest.skip("no C compiler: the host runtime did not build")


@contextlib.contextmanager
def route(name: str, packages=("port", "ref")):
    """Run the named packages on one route: "c" or "numpy"."""
    with pytest.MonkeyPatch.context() as mp:
        for pkg in packages:
            nat, ser = {"port": (tnative, tser), "ref": (rnative, rser)}[pkg]
            if name == "numpy":
                mp.setattr(nat, "_lib", False)
            mp.setattr(ser, "_native_lib", False if name == "numpy" else None)
        yield


def _all_routes(port_fn, ref_fn):
    """[port C, port numpy, ref C, ref numpy] results."""
    out = []
    for pkg, fn in (("port", port_fn), ("ref", ref_fn)):
        for name in ("c", "numpy"):
            with route(name, (pkg,)):
                out.append(fn())
    return out


def _same(results):
    """Equal values on all four; equal types and dtypes between the two
    packages on each route (a route's arrays may differ in dtype: the C
    Huffman build returns int32 codes, numpy's are uint32, in both)."""
    def check(x, y, types):
        if isinstance(x, tuple):
            assert isinstance(y, tuple) and len(x) == len(y)
            for a, b in zip(x, y):
                check(a, b, types)
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y)
            assert not types or x.dtype == y.dtype
        else:
            assert x == y
            assert not types or type(x) is type(y)
    for r in results[1:]:
        check(results[0], r, False)
    check(results[0], results[2], True)
    check(results[1], results[3], True)


def test_library_builds_into_the_package_build_dir():
    path = tnative.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "zlibng_tpu_torch"
    assert path.exists() and tnative.available()


def test_no_compiler_leaves_the_numpy_routes(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_build", lambda so_path: False)
    monkeypatch.setattr(tser, "_native_lib", None)
    assert not tnative.available()
    data = sample("pigz", 20000)
    assert adler32(data) == zlib.adler32(data)
    assert crc32(data) == zlib.crc32(data)
    out, _ = tser.inflate_raw(raw_deflate(data))
    assert type(out) is bytes and out == data


@pytest.mark.parametrize("name", ["c", "numpy"])
def test_checksums_match_zlib(name):
    rng = np.random.default_rng(3)
    with route(name):
        for n in (0, 1, 7, 5551, 5552, 5553, 70000):
            b = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for seed in (1, 0, 0xDEADBEEF):
                for form in (b, bytearray(b), memoryview(b)[0:],
                             np.frombuffer(b, np.uint8)):
                    assert adler32(form, seed) == zlib.adler32(b, seed)
                    assert crc32(form, seed) == zlib.crc32(b, seed)


def _freq_sets():
    rng = np.random.default_rng(7)
    sets = []
    for n in (286, 30, 19):
        sets.append(rng.integers(0, 50, n))
        sets.append((2.0 ** rng.uniform(0, 24, n)).astype(np.int64))
        sets.append(np.where(rng.random(n) < 0.1, rng.integers(1, 9, n), 0))
        one = np.zeros(n, np.int64)
        one[n // 2] = 5
        sets.append(one)
        sets.append(np.zeros(n, np.int64))
    fib = [1, 1]
    while len(fib) < 30:
        fib.append(fib[-1] + fib[-2])
    sets.append(np.array(fib, np.int64))           # depth past 15 bits
    return sets


@pytest.mark.parametrize("i", range(16))
def test_huffman_builds_match_reference(i):
    freqs = _freq_sets()[i]
    # 7 bits is the code-length tree's limit (19 symbols)
    for max_bits in (15, 7) if freqs.size == 19 else (15,):
        _same(_all_routes(lambda: tenc.huffman_table(freqs, max_bits),
                          lambda: renc.huffman_table(freqs, max_bits)))
    lit = tenc.huffman_table(np.pad(freqs, (0, 286))[:286] + (
        np.arange(286) == 256), 15)[0]
    dist = tenc.huffman_table(np.pad(freqs, (0, 30))[:30], 15)[0]
    _same(_all_routes(lambda: tenc.build_dynamic_header(lit, dist),
                      lambda: renc.build_dynamic_header(lit, dist)))


def _lut_cases():
    rng = np.random.default_rng(9)
    cases = []
    for _ in range(6):
        f = rng.integers(0, 60, 286)
        f[256] = 1
        cases.append(("lens", tenc.huffman_table(f, 15)[0], 15))
        cases.append(("lens", tenc.huffman_table(f, 9)[0], 9))
    one = np.zeros(30, np.int32)
    one[4] = 1
    cases.append(("dists", one, 15))              # one 1-bit code: allowed
    cases.append(("dists", np.full(30, 5, np.int32), 5))
    cases.append(("lens", np.full(286, 1, np.int32), 15))   # oversubscribed
    cases.append(("lens", np.array([2, 2] + [0] * 284, np.int32), 15))
    cases.append(("dists", np.zeros(30, np.int32), 15))     # empty
    return cases


@pytest.mark.parametrize("i", range(17))
def test_decode_lut_fill_matches_reference(i):
    kind, lengths, max_len = _lut_cases()[i]

    def build(dt):
        k = dt.LENS if kind == "lens" else dt.DISTS
        try:
            return ("ok", dt.build_packed_lut(lengths, k, max_len=max_len))
        except dt.InvalidCodeError as e:
            return ("invalid", str(e))
    _same(_all_routes(lambda: build(tdt), lambda: build(rdt)))


def _serial_outcome(ser, payload, wbits=15, dictionary=None, dribble=False,
                    one_shot=False):
    try:
        if one_shot:
            out, bits = ser.inflate_raw(payload, wbits=wbits,
                                        dictionary=dictionary)
            return ("ok", bytes(out), bits, type(out).__name__)
        inf = ser.RawInflater(wbits=wbits, dictionary=dictionary)
        if dribble:
            r = None
            for i in range(len(payload)):
                inf.feed(payload[i:i + 1])
                r = inf.run(finish=(i == len(payload) - 1))
        else:
            inf.feed(payload)
            r = inf.run(finish=True)
        return ("ok", inf.output(), inf.bitpos, inf.codes_used, r)
    except ser.InflateError as e:
        return ("error", str(e))


def _serial_streams():
    data = pigz()[:60000]
    dct = sample("text", 3000)
    s = {f"zlib L{lv}": (raw_deflate(data, lv), {}) for lv in (0, 1, 6, 9)}
    s["Z_FIXED"] = (raw_deflate(data, 6, strategy=zlib.Z_FIXED), {})
    s["Z_RLE"] = (raw_deflate(data, 6, strategy=zlib.Z_RLE), {})
    s["dictionary"] = (raw_deflate(data, zdict=dct), {"dictionary": dct})
    s["missing dictionary"] = (raw_deflate(data, zdict=dct), {})
    for w in range(9, 16):
        s[f"windowBits {w}"] = (raw_deflate(data[:20000], wbits=-w),
                                {"wbits": w})
    s["windowBits 8, stream of 9"] = (raw_deflate(data[:20000], wbits=-9),
                                      {"wbits": 8})
    rng = np.random.default_rng(12)
    base = raw_deflate(data[:30000])
    for j in range(6):
        c = bytearray(base)
        c[int(rng.integers(len(c)))] ^= 1 << int(rng.integers(8))
        s[f"bit flip {j}"] = (bytes(c), {})
    s["truncated"] = (base[:len(base) // 2], {})
    return s


SERIAL = _serial_streams()


@pytest.mark.parametrize("name", sorted(SERIAL))
def test_serial_decoder_routes_match(name):
    """Whole streams through RawInflater and the one-shot inflate_raw:
    the port's C route against its numpy route and the reference's C
    route (and the reference's numpy route)."""
    payload, kw = SERIAL[name]
    for one_shot in (False, True):
        res = _all_routes(
            lambda: _serial_outcome(tser, payload, one_shot=one_shot, **kw),
            lambda: _serial_outcome(rser, payload, one_shot=one_shot, **kw))
        if one_shot:            # the return type differs by route
            assert [r[-1] for r in res if r[0] == "ok"] in (
                [], ["memoryview", "bytes"] * 2)
            res = [r[:-1] if r[0] == "ok" else r for r in res]
        _same(res)


@pytest.mark.parametrize("name", ["zlib L6", "Z_FIXED", "dictionary",
                                  "windowBits 9", "bit flip 0", "truncated"])
def test_serial_decoder_dribble_routes_match(name):
    """One byte fed at a time: every NEED_INPUT edge on both routes."""
    payload, kw = SERIAL[name]
    payload = payload[:2500]
    _same(_all_routes(
        lambda: _serial_outcome(tser, payload, dribble=True, **kw),
        lambda: _serial_outcome(rser, payload, dribble=True, **kw)))


def _decode_outcome(fn, stats, err):
    before = dict(stats)
    try:
        got = fn()
        got = (bytes(got), type(got).__name__)
    except err as e:
        got = f"error: {e}"
    return got, {k: stats[k] - before[k] for k in before}


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_corrupt_streams_word_errors_alike_on_every_route(name):
    """decompress_cuda(device="cpu") and decompress_tpu on the C and the
    numpy routes: one outcome, one `stats` move."""
    stream, kw = CORRUPT[name]
    res = _all_routes(
        lambda: _decode_outcome(lambda: decompress_cuda(
            stream, device="cpu", **kw), ti.stats, DataError),
        lambda: _decode_outcome(lambda: itpu.decompress_tpu(stream, **kw),
                                itpu.stats, RefDataError))
    assert res[0] == res[2] and res[1] == res[3]
    strip = [(o[0] if isinstance(o, tuple) else o, st) for o, st in res]
    assert strip[0] == strip[1]                   # C words it as numpy does


@pytest.mark.parametrize("engine", ["host", "device"])
def test_decode_return_types_match_reference(engine):
    """The host engine's one-shot decode returns a zero-copy memoryview on
    the C route and bytes on the numpy route, in both packages; the device
    route returns bytes."""
    data = pigz()[:30000]
    z = zlib.compress(data, 6)
    for name in ("c", "numpy"):
        with route(name):
            a = decompress_cuda(z, engine=engine, device="cpu")
            b = itpu.decompress_tpu(z, engine=engine)
        assert type(a) is type(b)
        assert a == b == data
        want = memoryview if (name, engine) == ("c", "host") else bytes
        assert type(a) is want


def test_held_results_survive_later_decodes():
    data = pigz()[:120000]
    a = decompress_cuda(zlib.compress(data[:50000]), engine="host",
                        device="cpu")
    b = decompress_cuda(zlib.compress(data[50000:90000]), engine="host",
                        device="cpu")
    c = decompress_cuda(zlib.compress(data[90000:]), engine="host",
                        device="cpu")
    assert isinstance(a, memoryview)
    assert a == data[:50000] and b == data[50000:90000] and c == data[90000:]


def test_canonical_loop_reuses_warm_buffers():
    """`out = decompress(...)` in a loop holds the previous result during
    each call; the two-slot pool still serves warm buffers."""
    data = pigz()[:100000]
    zc = zlib.compress(data, 6)
    gc.collect()
    addrs = []
    out = None
    for _ in range(6):
        out = decompress_cuda(zc, engine="host", device="cpu")
        assert isinstance(out, memoryview)
        arr = np.frombuffer(out, np.uint8)
        addrs.append(arr.__array_interface__["data"][0])
        del arr
    assert out == data
    assert max(addrs.count(a) for a in addrs) >= 3, addrs


def test_native_ptr_keepalive_is_acyclic():
    a = np.zeros(4096, np.uint8)
    base = sys.getrefcount(a)
    mv = memoryview(a)[16:4000]
    tnative.adler32(mv)
    tnative.crc32(mv)
    del mv
    assert sys.getrefcount(a) == base
