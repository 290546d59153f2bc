"""The port's streaming API (`zlibng_tpu_torch/stream/api.py`: Deflate and
Inflate) against the JAX package's (`zlibng_tpu/stream/api.py`), replaying
the public-surface assertions of test_stream_api.py, test_prime_pending.py,
test_inflate_block_trees.py and the Deflate/Inflate cases of
test_concurrency.py and test_parity_r2.py. Each scenario runs on both
packages with the same inputs, and both must give the same bytes, error
class name and text, `mark()`, `codes_used()`, `pending()`, `data_type`,
`get_header()` and `eof`; zlib is the oracle besides. Inflate runs on both
routes of the serial decoder (the C stream engine and numpy), each package
pinned to the same one.

`both`, `outcome` and the package namespaces are shared with the other
test_torch_* files of the public surface."""
import dataclasses
import gzip
import struct
import threading
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

import zlibng_tpu.compat as r_compat
import zlibng_tpu.pyzlib as r_pyzlib
import zlibng_tpu.zng as r_zng
from zlibng_tpu import errors as r_errors
from zlibng_tpu.cli import minideflate as r_minideflate
from zlibng_tpu.cli import minigzip as r_minigzip
from zlibng_tpu.format import headers as r_headers
from zlibng_tpu.parallel import index as r_index
from zlibng_tpu.stream import api as r_api
from zlibng_tpu.stream import deflate as r_deflate
from zlibng_tpu.stream import gzfile as r_gzfile
from zlibng_tpu.stream import inflate as r_inflate
import zlibng_tpu_torch.compat as p_compat
import zlibng_tpu_torch.pyzlib as p_pyzlib
import zlibng_tpu_torch.zng as p_zng
from zlibng_tpu_torch import errors as p_errors
from zlibng_tpu_torch.cli import minideflate as p_minideflate
from zlibng_tpu_torch.cli import minigzip as p_minigzip
from zlibng_tpu_torch.format import headers as p_headers
from zlibng_tpu_torch.parallel import index as p_index
from zlibng_tpu_torch.stream import api as p_api
from zlibng_tpu_torch.stream import deflate as p_deflate
from zlibng_tpu_torch.stream import gzfile as p_gzfile
from zlibng_tpu_torch.stream import inflate as p_inflate

from test_torch_native import route
from torch_corpus import pigz

REF = SimpleNamespace(
    name="ref", api=r_api, D=r_deflate, inflate=r_inflate, gzfile=r_gzfile,
    errors=r_errors, H=r_headers, pyzlib=r_pyzlib, zng=r_zng,
    compat=r_compat, index=r_index, minigzip=r_minigzip,
    minideflate=r_minideflate)
PORT = SimpleNamespace(
    name="port", api=p_api, D=p_deflate, inflate=p_inflate, gzfile=p_gzfile,
    errors=p_errors, H=p_headers, pyzlib=p_pyzlib, zng=p_zng,
    compat=p_compat, index=p_index, minigzip=p_minigzip,
    minideflate=p_minideflate)


def outcome(fn):
    """fn()'s value, or ("raised", error class name, text)."""
    try:
        return fn()
    except Exception as e:      # any class: both packages must raise alike
        return ("raised", type(e).__name__, str(e))


def both(scenario, *args):
    """scenario(pkg, *args) on the port and on the reference: equal
    results, returned."""
    got = scenario(PORT, *args)
    want = scenario(REF, *args)
    assert got == want
    return got


def header_fields(h):
    """A GzipHeader (either package's) as a plain tuple, or None."""
    return None if h is None else tuple(dataclasses.astuple(h))


ROUTES = ["c", "numpy"]
TEXT = b"streaming compression with flush modes and state capture " * 2000
SMALL = TEXT[:30000]


# ---------------------------------------------------------------------------
# Deflate
# ---------------------------------------------------------------------------
def _basic(m):
    d = m.api.Deflate(level=6)
    out = d.compress(TEXT) + d.compress(b"", m.api.Z_FINISH)
    assert zlib.decompress(out) == TEXT
    return out, d.total_in, d.total_out, d.adler, d.data_type, d.pending()


def test_basic_roundtrip():
    both(_basic)


def _chunked(m):
    d = m.api.Deflate(level=6)
    out = bytearray()
    sizes = []
    for i in range(0, len(TEXT), 7000):
        part = d.compress(TEXT[i:i + 7000])
        sizes.append(len(part))
        out += part
    out += d.flush()
    assert zlib.decompress(bytes(out)) == TEXT
    return bytes(out), sizes


def test_chunked_input_eager_blocks():
    both(_chunked)


FLUSHES = ["Z_NO_FLUSH", "Z_PARTIAL_FLUSH", "Z_SYNC_FLUSH", "Z_FULL_FLUSH",
           "Z_BLOCK", "Z_TREES"]


def _flush_mode(m, name):
    d = m.api.Deflate(level=6)
    out = d.compress(SMALL[:5000], getattr(m.api, name))
    pend = d.pending()
    if name in ("Z_SYNC_FLUSH", "Z_FULL_FLUSH"):
        assert out.endswith(b"\x00\x00\xff\xff")
        assert zlib.decompressobj().decompress(out) == SMALL[:5000]
    out += d.compress(SMALL[5000:], m.api.Z_FINISH)
    assert zlib.decompress(out) == SMALL
    bad = outcome(lambda: m.api.Deflate().compress(b"x", 9))
    return out, pend, bad


@pytest.mark.parametrize("name", FLUSHES)
def test_flush_modes(name):
    both(_flush_mode, name)


def _sync_consumer(m):
    d = m.api.Deflate(level=6)
    dec = zlib.decompressobj()
    got, parts = bytearray(), []
    for i in range(0, 30000, 3000):
        chunk = d.compress(TEXT[i:i + 3000], m.api.Z_SYNC_FLUSH)
        parts.append(chunk)
        got += dec.decompress(chunk)
    assert bytes(got) == TEXT[:30000]
    return parts


def test_sync_flush_incremental_consumer():
    both(_sync_consumer)


def _full_flush_history(m):
    d = m.api.Deflate(level=6)
    a = d.compress(TEXT[:40000], m.api.Z_FULL_FLUSH)
    b = d.compress(TEXT[:40000], m.api.Z_FINISH)
    assert zlib.decompress(a + b) == TEXT[:40000] * 2
    return a, b, d.get_dictionary()[-100:]


def test_full_flush_resets_history():
    both(_full_flush_history)


def _copy(m):
    d = m.api.Deflate(level=6)
    pre = d.compress(SMALL[:10000], m.api.Z_SYNC_FLUSH)
    d2 = d.copy()
    out1 = pre + d.compress(b"AAA", m.api.Z_FINISH)
    out2 = pre + d2.compress(b"BBB", m.api.Z_FINISH)
    assert zlib.decompress(out1).endswith(b"AAA")
    assert zlib.decompress(out2).endswith(b"BBB")
    after = outcome(lambda: d.compress(b"more"))
    return out1, out2, after, d.compress(b"")


def test_deflate_copy_diverges():
    both(_copy)


def _gzip_header(m, route_name):
    d = m.api.Deflate(wbits=31)
    d.set_header(m.H.GzipHeader(name=b"f.txt", time=123456, comment=b"hi",
                                extra=b"xy", hcrc=True))
    errs = [outcome(lambda: d.set_dictionary(b"abc"))]
    out = d.compress(SMALL, m.api.Z_FINISH)
    errs.append(outcome(lambda: d.set_header(m.H.GzipHeader())))
    errs.append(outcome(lambda: m.api.Deflate().set_header(
        m.H.GzipHeader())))
    assert gzip.decompress(out) == SMALL
    with route(route_name):
        inf = m.api.Inflate(wbits=31)
        got = inf.decompress(out, finish=True)
    assert got == SMALL and inf.eof
    return (out, errs, header_fields(inf.get_header()), inf.mark(),
            inf.codes_used(), inf.data_type, inf.adler, inf.total_out)


@pytest.mark.parametrize("route_name", ROUTES)
def test_gzip_mode_with_header(route_name):
    h = both(_gzip_header, route_name)[2]
    assert h[1] == 123456 and h[4:8] == (b"xy", b"f.txt", b"hi", True)


def _raw(m):
    d = m.api.Deflate(wbits=-15)
    out = d.compress(SMALL, m.api.Z_FINISH)
    assert zlib.decompress(out, -15) == SMALL
    return out, d.adler


def test_raw_mode():
    both(_raw)


DICT = b"the quick brown fox jumps over the lazy dog"
DICT_DATA = b"a quick brown fox jumped over lazy dogs " * 50


def _dictionary(m, route_name):
    d = m.api.Deflate(level=6)
    d.set_dictionary(DICT)
    out = d.compress(DICT_DATA, m.api.Z_FINISH)
    late = outcome(lambda: d.set_dictionary(DICT))
    dec = zlib.decompressobj(zdict=DICT)
    assert dec.decompress(out) == DICT_DATA
    with route(route_name):
        inf = m.api.Inflate()
        need = outcome(lambda: inf.decompress(out, finish=True))
        wrong = outcome(lambda: inf.set_dictionary(b"not the dictionary"))
        inf.set_dictionary(DICT)
        got = inf.decompress(b"", finish=True)
        inf2 = m.api.Inflate(dictionary=b"wrong dictionary")
        wrong2 = outcome(lambda: inf2.decompress(out, finish=True))
    assert got == DICT_DATA
    return (out, late, need, wrong, wrong2, inf.mark(), inf.codes_used(),
            inf.get_dictionary()[-50:])


@pytest.mark.parametrize("route_name", ROUTES)
def test_dictionary_stream(route_name):
    got = both(_dictionary, route_name)
    assert got[2][:2] == ("raised", "NeedDictError")


def _params_tune(m):
    d = m.api.Deflate(level=1)
    out = d.compress(TEXT[:30000])
    d.params(9)
    out += d.compress(TEXT[30000:60000], m.api.Z_FINISH)
    assert zlib.decompress(out) == TEXT[:60000]
    before = dict(m.D.LEVELS)
    t = m.api.Deflate(level=6)
    t.tune(8, 4, 16, 2)         # good, lazy, nice, chain
    tuned = t.compress(TEXT[:60000], m.api.Z_FINISH)
    assert zlib.decompress(tuned) == TEXT[:60000]
    assert m.D.LEVELS == before
    p = m.api.Deflate(level=6)
    huff = p.compress(SMALL[:10000])
    p.params(2, m.D.Z_HUFFMAN_ONLY)
    huff += p.compress(SMALL[10000:], m.api.Z_FINISH)
    assert zlib.decompress(huff) == SMALL
    return out, tuned, huff, (p.level, p.strategy)


def test_deflate_params_and_tune():
    both(_params_tune)


def _reset(m, route_name):
    d = m.api.Deflate(level=6)
    a = d.compress(b"hello", m.api.Z_FINISH)
    d.reset()
    b = d.compress(b"hello", m.api.Z_FINISH)
    with route(route_name):
        inf = m.api.Inflate()
        x = inf.decompress(a, finish=True)
        inf.reset()
        y = inf.decompress(b, finish=True)
        inf.reset(-15)
        z = inf.decompress(a[2:-4], finish=True)
    return a, b, x, y, z, inf.wbits, inf.eof


@pytest.mark.parametrize("route_name", ROUTES)
def test_reset_reuse(route_name):
    got = both(_reset, route_name)
    assert got[0] == got[1] and got[2:5] == (b"hello",) * 3


def _strip_bits(blob: bytes, k: int) -> tuple[int, bytes]:
    """(first k bits LSB-first, the rest of the stream shifted right k)."""
    big = int.from_bytes(blob, "little")
    nbits = len(blob) * 8 - k
    return big & ((1 << k) - 1), (big >> k).to_bytes((nbits + 7) // 8,
                                                      "little")


PRIME_DATA = b"prime edge payload " * 300 + bytes(range(256)) * 4


def _deflate_prime(m, k):
    v = 0b1011001110110011 & ((1 << k) - 1)
    d = m.api.Deflate(level=6, wbits=-15)
    d.prime(k, v)
    pend = d.pending()
    out = d.compress(PRIME_DATA, m.api.Z_FINISH)
    first, rest = _strip_bits(out, k)
    assert first == v and zlib.decompress(rest, -15) == PRIME_DATA
    bad = [outcome(lambda: m.api.Deflate().prime(17, 0)),
           outcome(lambda: m.api.Deflate().prime(-1, 0))]
    return out, pend, d.pending(), bad


@pytest.mark.parametrize("k", [1, 3, 5, 7, 8, 11, 16])
def test_deflate_prime_bit_exact(k):
    both(_deflate_prime, k)


def _pending(m):
    d = m.api.Deflate(level=6, wbits=-15)
    d.prime(3, 0b101)
    p0 = d.pending()
    got = d.compress(PRIME_DATA[:100])
    p1 = d.pending()
    out = got + d.compress(PRIME_DATA[100:], m.api.Z_FINISH)
    first, rest = _strip_bits(out, 3)
    assert first == 0b101 and zlib.decompress(rest, -15) == PRIME_DATA
    s = m.api.Deflate(level=1, wbits=-15)
    s.prime(16, 0xBEEF)
    stitched = s.compress(b"abc" * 500, m.api.Z_FINISH)
    assert int.from_bytes(stitched[:2], "little") == 0xBEEF
    assert zlib.decompress(stitched[2:], -15) == b"abc" * 500
    return p0, p1, d.pending(), out, stitched


def test_deflate_pending_and_16bit_stitch():
    got = both(_pending)
    assert got[0] == (0, 3) and got[2][0] == 0


BOUND_CASES = [b"", b"x", np.random.default_rng(3).integers(
    0, 256, 9, np.uint8).tobytes(), np.random.default_rng(3).integers(
    0, 256, 10_000, np.uint8).tobytes(), bytes(40_000), b"ab" * 10_000]


def _bound(m, level):
    res = []
    for data in BOUND_CASES:
        for wbits in (15, -15, 31):
            d = m.api.Deflate(level=level, wbits=wbits)
            bound = d.bound(len(data))
            out = d.compress(data, flush=4)
            assert len(out) <= bound
            res.append((bound, out))
    return res, m.api.Deflate(level=level).bound(1 << 20)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_bound_covers_worst_case(level):
    both(_bound, level)


def _bound_tight(m):
    n = 1 << 20
    tight = m.api.Deflate(level=6).bound(n)
    conservative = m.D.compress_bound(n)
    assert tight < conservative
    assert m.api.Deflate(level=0).bound(n) < n + n // 16
    with_dict = m.api.Deflate(level=6, dictionary=b"abc").bound(n)
    return tight, conservative, with_dict


def test_bound_tight_for_default_params():
    both(_bound_tight)


DATA_TYPES = {"text": (6, b"The quick brown fox.\n" * 100),
              "binary": (6, bytes(range(256)) * 40),
              "gray only": (6, bytes([7, 8, 11, 12, 26, 27]) * 50),
              "level 0": (0, b"plain text here" * 10)}


def _data_type(m, name):
    level, data = DATA_TYPES[name]
    d = m.api.Deflate(level=level)
    before = d.data_type
    out = d.compress(data, flush=4)
    return before, d.data_type, out


@pytest.mark.parametrize("name", list(DATA_TYPES))
def test_data_type(name):
    before, after, _ = both(_data_type, name)
    assert before == p_deflate.Z_UNKNOWN
    assert after == {"text": p_deflate.Z_TEXT, "level 0": p_deflate.Z_UNKNOWN
                     }.get(name, p_deflate.Z_BINARY)


def _init_errors(m):
    return [outcome(lambda: m.api.Deflate(**kw)) for kw in (
        dict(method=9), dict(wbits=7), dict(wbits=32), dict(wbits=-16),
        dict(level=10), dict(level=-2))] + [
        outcome(lambda: m.api.Inflate(wbits=48)),
        outcome(lambda: m.api.Inflate(wbits=-16))]


def test_init_errors():
    got = both(_init_errors)
    assert all(r[0] == "raised" for r in got)


def _mem_level(m, mem_level):
    d = m.api.Deflate(level=6, wbits=-15, mem_level=mem_level)
    out = d.compress(TEXT[:40000], m.api.Z_FINISH)
    assert zlib.decompress(out, -15) == TEXT[:40000]
    return d.block_size, out


@pytest.mark.parametrize("mem_level", [1, 4, 9])
def test_mem_level_block_size(mem_level):
    both(_mem_level, mem_level)


def _host_compress(m, level, block_size):
    data = pigz()[:50000]
    out = m.D.compress(data, level, block_size=block_size)
    assert zlib.decompress(out) == data
    raw = m.D.compress(data[:9000], level, -15, 0, None, block_size)
    assert zlib.decompress(raw, -15) == data[:9000]
    return out, raw


@pytest.mark.parametrize("level,block_size", [(0, 4096), (0, 1 << 17),
                                              (6, 8192), (1, 20000)])
def test_host_compress_block_size(level, block_size):
    """The one-shot host encoder (`compress`, exported at the top level)
    takes the reference's block_size and gives its bytes."""
    both(_host_compress, level, block_size)


def _payload(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10),
                                dtype=np.uint8)) for _ in range(40)]
    out, i = bytearray(), 0
    while len(out) < n:
        out += words[(i * 13) % 40] + b" "
        i += 1
    return bytes(out[:n])


def _stream_worker(m, data: bytes) -> tuple[bytes, bytes]:
    d = m.api.Deflate(level=6)
    out = bytearray()
    for off in range(0, len(data), 17_000):
        out += d.compress(data[off:off + 17_000])
    out += d.flush(m.api.Z_FINISH)
    inf = m.api.Inflate()
    got = bytearray()
    for off in range(0, len(out), 7_001):
        got += inf.decompress(bytes(out[off:off + 7_001]))
    return bytes(out), bytes(got)


def test_concurrent_streaming_objects():
    """Independent Deflate/Inflate objects on 4 threads: each thread's
    stream equals the reference's serial stream of its payload."""
    payloads = [_payload(200 + i, 40_000) for i in range(4)]
    want = [_stream_worker(REF, p) for p in payloads]
    got = [None] * len(payloads)
    barrier = threading.Barrier(len(payloads))

    def work(i):
        barrier.wait(timeout=60)
        got[i] = outcome(lambda: _stream_worker(PORT, payloads[i]))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert got == want
    assert all(g[1] == p for g, p in zip(got, payloads))


# ---------------------------------------------------------------------------
# Inflate
# ---------------------------------------------------------------------------
def _state(inf):
    """What the surface shows of an Inflate after a call."""
    return (inf.eof, inf.mark(), inf.codes_used(), inf.data_type,
            inf.total_in, inf.total_out, inf.adler, inf.sync_point())


def _streaming(m, route_name, step):
    comp = zlib.compress(TEXT[:60000], 9) + b"tail"
    with route(route_name):
        inf = m.api.Inflate()
        out, states = bytearray(), []
        for i in range(0, len(comp), step):
            out += inf.decompress(comp[i:i + step],
                                  finish=i + step >= len(comp))
            states.append(_state(inf))
    assert bytes(out) == TEXT[:60000]
    return bytes(out), states, inf.unused_data, inf.decompress(b"more")


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("step", [1, 501])
def test_inflate_streaming_chunks(route_name, step):
    """Byte-dribbled and chunked input: the same output, counters and
    data_type after every call."""
    both(_streaming, route_name, step)


def _three_blocks():
    co = zlib.compressobj(6)
    parts = [b"first block of text " * 50,
             b"second block, different content " * 40,
             b"third and final block " * 30]
    out = co.compress(parts[0]) + co.flush(zlib.Z_FULL_FLUSH)
    out += co.compress(parts[1]) + co.flush(zlib.Z_FULL_FLUSH)
    out += co.compress(parts[2]) + co.flush(zlib.Z_FINISH)
    return out, b"".join(parts)


VARIED = np.random.default_rng(0).integers(32, 127, 60_000,
                                           np.uint8).tobytes()
STOP_STREAMS = {
    "three blocks": lambda: _three_blocks(),
    "dynamic block": lambda: (zlib.compress(VARIED, 6), VARIED),
    "stored blocks": lambda: (zlib.compress(bytes(range(256)) * 300, 0),
                              bytes(range(256)) * 300),
    "fixed block": lambda: (lambda co: (co.compress(b"zz") + co.flush(),
                                        b"zz"))(
        zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)),
    "gzip": lambda: (gzip.compress(b"gzip framed payload " * 100),
                     b"gzip framed payload " * 100),
}


def _stops(m, route_name, name, flush):
    comp, want = STOP_STREAMS[name]()
    wbits = 31 if name == "gzip" else 15
    with route(route_name):
        inf = m.api.Inflate(wbits=wbits)
        got, steps = bytearray(), []
        chunk = inf.decompress(comp, flush=getattr(m.api, flush))
        steps.append((chunk, _state(inf), inf._raw.bitpos))
        for _ in range(200):
            if inf.eof:
                break
            chunk = inf.decompress(b"", flush=getattr(m.api, flush))
            got += chunk
            steps.append((len(chunk), _state(inf), inf._raw.bitpos))
    assert bytes(got) == want
    return steps


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("flush", ["Z_BLOCK", "Z_TREES"])
@pytest.mark.parametrize("name", list(STOP_STREAMS))
def test_block_and_trees_stops(route_name, flush, name):
    """Z_BLOCK and Z_TREES step a stream stop by stop: the same output,
    data_type (boundary, last-block and after-header flags), bit position,
    mark and codes_used at every stop, on both routes."""
    steps = both(_stops, route_name, name, flush)
    assert steps[0][1][3] & 128
    if flush == "Z_TREES" and name != "stored blocks":
        assert any(s[1][3] & 256 for s in steps)


def _sync(m, route_name):
    d = m.api.Deflate(level=6, wbits=-15)
    part1 = d.compress(b"first block data " * 100, m.api.Z_FULL_FLUSH)
    part2 = d.compress(b"second block data " * 100, m.api.Z_FINISH)
    corrupted = b"\xde\xad" + part1[-4:] + part2
    with route(route_name):
        inf = m.api.Inflate(wbits=-15)
        first = outcome(lambda: inf.decompress(corrupted, finish=False))
        synced = inf.sync()
        out = inf.decompress(b"", finish=True)
        none = m.api.Inflate(wbits=-15)
        none.decompress(b"\x01\x02", finish=False)
        no_marker = none.sync()
    assert synced and b"second block data" in out
    return part1, part2, first, out, _state(inf), no_marker


@pytest.mark.parametrize("route_name", ROUTES)
def test_inflate_sync_resync(route_name):
    both(_sync, route_name)


def _full_flush_sync(m, route_name):
    """Deflate with Z_FULL_FLUSH, then Inflate.sync() past a damaged
    segment: the rest decodes."""
    data = pigz()[:60000]
    d = m.api.Deflate(level=6, wbits=-15)
    segs = [d.compress(data[i:i + 20000], m.api.Z_FULL_FLUSH if i < 40000
                       else m.api.Z_FINISH) for i in range(0, 60000, 20000)]
    blob = bytearray(b"".join(segs))
    blob[100] ^= 0xFF
    with route(route_name):
        inf = m.api.Inflate(wbits=-15)
        err = outcome(lambda: inf.decompress(bytes(blob[:len(segs[0])])))
        inf.sync()
        rest = inf.decompress(bytes(blob[len(segs[0]):]), finish=True)
    return segs, err, rest[-40000:] == data[20000:], _state(inf)


@pytest.mark.parametrize("route_name", ROUTES)
def test_full_flush_then_sync(route_name):
    got = both(_full_flush_sync, route_name)
    assert got[2]


def _inflate_copy(m, route_name):
    comp = zlib.compress(TEXT[:60000])
    with route(route_name):
        inf = m.api.Inflate()
        head = inf.decompress(comp[:200])
        inf2 = inf.copy()
        a = inf.decompress(comp[200:], finish=True)
        b = inf2.decompress(comp[200:], finish=True)
    assert a == b and head + a == TEXT[:60000]
    return head, a, _state(inf), _state(inf2)


@pytest.mark.parametrize("route_name", ROUTES)
def test_inflate_copy(route_name):
    both(_inflate_copy, route_name)


def _auto_detect(m, route_name):
    res = []
    with route(route_name):
        for blob in (zlib.compress(SMALL), gzip.compress(SMALL)):
            inf = m.api.Inflate(wbits=47)
            res.append((inf.decompress(blob, finish=True), _state(inf),
                        header_fields(inf.get_header())))
    assert all(r[0] == SMALL for r in res)
    return res


@pytest.mark.parametrize("route_name", ROUTES)
def test_auto_detect_stream(route_name):
    both(_auto_detect, route_name)


def _validate(m, route_name):
    good = zlib.compress(SMALL)
    bad = good[:-1] + bytes([good[-1] ^ 1])
    gz = bytearray(gzip.compress(SMALL))
    gz[-8] ^= 1
    res = []
    with route(route_name):
        for blob, wbits in ((bad, 15), (bytes(gz), 31)):
            for check in (True, False):
                inf = m.api.Inflate(wbits=wbits)
                inf.validate(check)
                res.append((outcome(lambda: inf.decompress(blob,
                                                          finish=True)),
                            inf.eof))
        trunc = m.api.Inflate()
        res.append(outcome(lambda: trunc.decompress(good[:-2], finish=True)))
        res.append(outcome(lambda: m.api.Inflate().undermine(True)))
        res.append(outcome(lambda: m.api.Inflate().prime(3, 1)))
    return res


@pytest.mark.parametrize("route_name", ROUTES)
def test_validate_undermine_and_errors(route_name):
    got = both(_validate, route_name)
    assert got[0][0] == ("raised", "DataError", "incorrect data check")
    assert got[1][0] == SMALL


def _inflate_prime(m, route_name, k, step):
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    c = co.compress(PRIME_DATA) + co.flush()
    first, rest = _strip_bits(c, k)
    with route(route_name):
        inf = m.api.Inflate(wbits=-15)
        if k == 11:                       # two primes stack: 8 then 3
            inf.prime(8, first & 0xFF)
            inf.prime(3, first >> 8)
        else:
            inf.prime(k, first)
        out, states = bytearray(), []
        for i in range(0, len(rest), step):
            out += inf.decompress(rest[i:i + step],
                                  finish=i + step >= len(rest))
            states.append(_state(inf))
        neg = m.api.Inflate(wbits=-15)
        neg.prime(5, 0b10101)
        neg.prime(-1, 0)
        reset = neg.decompress(c, finish=True)
    assert bytes(out) == PRIME_DATA and reset == PRIME_DATA
    bad = outcome(lambda: m.api.Inflate(wbits=-15).prime(17, 0))
    return states, bad


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("k,step", [(1, 1 << 20), (3, 97), (7, 1 << 20),
                                    (8, 97), (11, 1 << 20), (13, 1 << 20),
                                    (16, 1 << 20)])
def test_inflate_prime(route_name, k, step):
    both(_inflate_prime, route_name, k, step)


def _zlib_wrap(raw: bytes, payload: bytes, hwbits: int) -> bytes:
    cmf = 8 | ((hwbits - 8) << 4)
    flg = 0x40
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    return bytes([cmf, flg]) + raw + struct.pack(">I", zlib.adler32(payload))


def _windows(m, route_name):
    c = zlib.compress(b"hello world" * 50, 6)
    data = (b"A unique prefix sentence. " + bytes(16000)
            + b"A unique prefix sentence. ")
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    bogus = _zlib_wrap(co.compress(data) + co.flush(), data, 9)
    small = b"small window data " * 200
    co = zlib.compressobj(6, zlib.DEFLATED, 9)
    honest = co.compress(small) + co.flush()
    with route(route_name):
        res = [outcome(lambda: m.inflate.decompress(c, wbits=9)),
               outcome(lambda: m.api.Inflate(wbits=9).decompress(
                   c, finish=True)),
               outcome(lambda: m.api.Inflate(wbits=15).decompress(
                   bogus, finish=True)),
               outcome(lambda: m.api.Inflate(wbits=15).decompress(
                   honest, finish=True)),
               outcome(lambda: m.inflate.decompress(honest, wbits=9))]
    return res


@pytest.mark.parametrize("route_name", ROUTES)
def test_window_size_enforcement(route_name):
    got = both(_windows, route_name)
    assert got[0][2] == got[1][2] == "invalid window size"
    assert got[2][2] == "invalid distance too far back"
    assert got[3] == got[4] == b"small window data " * 200


def _without_data_type(result):
    """_streaming's result with data_type left out of every state."""
    out, states, *rest = result
    return out, [st[:3] + st[4:] for st in states], *rest


ROUTE_CASES = {
    # data_type's last-block flag (64) differs by route while a block
    # header is only partly fed: the numpy route sets it once BFINAL's bit
    # is read, the C engine once the whole header is parsed (both packages
    # alike: test_inflate_streaming_chunks[1-*] pins each route)
    "dribbled": lambda r: _without_data_type(_streaming(PORT, r, 1)),
    "chunked": lambda r: _streaming(PORT, r, 501),
    "Z_BLOCK, three blocks": lambda r: _stops(PORT, r, "three blocks",
                                              "Z_BLOCK"),
    "Z_TREES, dynamic block": lambda r: _stops(PORT, r, "dynamic block",
                                               "Z_TREES"),
    "sync": lambda r: _sync(PORT, r),
    "prime 11 in 97 B chunks": lambda r: _inflate_prime(PORT, r, 11, 97),
}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_inflate_counters_equal_on_both_routes(name):
    """mark(), codes_used(), data_type, the bit position and the output
    of the port's Inflate are the same on the C stream engine and on the
    numpy route."""
    assert ROUTE_CASES[name]("c") == ROUTE_CASES[name]("numpy")
