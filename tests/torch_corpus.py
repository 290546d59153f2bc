"""In-repo corpora for the PyTorch port's parity tests (tests/test_torch_*.py).

Only files under tests/fixtures and seeded synthetic bytes: the port's
tests read nothing outside the repository.
"""
import functools
import gzip
import os
import zlib

import numpy as np
import torch

# The test run spreads files over several worker processes on a few cores:
# one intra-op thread per process keeps torch's CPU kernels from
# oversubscribing the cores (its spinning thread pools slowed the parallel
# run several-fold).
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@functools.lru_cache(maxsize=None)
def pigz() -> bytes:
    """GH-979/pigz-2.6.tar.gz, gunzipped (432,640 B of tar: text + binary)."""
    with open(os.path.join(FIXTURES, "GH-979", "pigz-2.6.tar.gz"), "rb") as f:
        return gzip.decompress(f.read())


@functools.lru_cache(maxsize=None)
def text() -> bytes:
    """GH-751/test.txt (180,001 B)."""
    with open(os.path.join(FIXTURES, "GH-751", "test.txt"), "rb") as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def cve() -> bytes:
    """CVE-2018-25032/default.txt."""
    with open(os.path.join(FIXTURES, "CVE-2018-25032", "default.txt"),
              "rb") as f:
        return f.read()


def synthetic(kind: str, n: int, seed: int = 0) -> bytes:
    """Seeded bytes: 'a4'/'a16'/'a256' (uniform over that alphabet),
    'runs' (random bytes, geometric run lengths) or 'zeros'."""
    rng = np.random.default_rng(seed)
    if kind.startswith("a"):
        return rng.integers(0, int(kind[1:]), n, dtype=np.uint8).tobytes()
    if kind == "runs":
        vals = rng.integers(0, 256, n, dtype=np.uint8)
        return np.repeat(vals, rng.geometric(1 / 30, n)).tobytes()[:n]
    if kind == "zeros":
        return bytes(n)
    raise ValueError(kind)


def sample(name: str, n: int, seed: int = 0) -> bytes:
    """n bytes of a named corpus (fixtures repeat to length)."""
    if name in ("pigz", "text", "cve"):
        src = {"pigz": pigz, "text": text, "cve": cve}[name]()
        return (src * (n // len(src) + 1))[:n]
    return synthetic(name, n, seed)


def pigz_lanes() -> bytes:
    """Five 128 KiB lanes and a 300-byte tail (655,660 B), for pigz's block
    size: two of text and two of pigz's tarball (dynamic trees), one of
    uniform bytes (stored blocks), then a short piece of text (the static
    tree)."""
    return (sample("text", 2 << 17) + pigz()[:2 << 17]
            + synthetic("a256", 1 << 17, seed=5) + text()[5000:5300])


def freq_cases(n: int, seed: int) -> np.ndarray:
    """Adversarial and random frequency rows for an alphabet of n symbols
    (the generator of tests/test_huffman_jax.py): all zero, one symbol, two,
    all equal, Fibonacci, powers of two (the Kraft restore), random sparse,
    Poisson and Zipf-like rows, and for n = 286 the oversubscribed
    fixture. (rows, n) int32."""
    rng = np.random.default_rng(seed)
    z = np.zeros(n, np.int64)
    cases = [z.copy()]
    o = z.copy(); o[min(65, n - 1)] = 7; cases.append(o)
    t = z.copy(); t[1] = 1; t[2] = 1; cases.append(t)
    cases.append(np.full(n, 3, np.int64))
    fib = z.copy()
    a, b = 1, 1
    for i in range(min(25, n)):
        fib[i] = a
        a, b = b, a + b
    cases.append(fib)
    pw = z.copy()
    for i in range(min(20, n)):
        pw[i] = 1 << i                           # forces >15-bit overflow
    cases.append(pw)
    for _ in range(60):
        k = rng.integers(1, n)
        f = np.zeros(n, np.int64)
        f[rng.choice(n, k, replace=False)] = rng.integers(1, 10000, k)
        cases.append(f)
    for _ in range(30):
        cases.append(rng.poisson(5, n).astype(np.int64))
    for _ in range(30):
        f = (10000 / (1 + np.arange(n)) ** rng.uniform(0.5, 2.0))
        f = f.astype(np.int64)
        rng.shuffle(f)
        cases.append(f)
    if n == 286:
        cases.append(np.load(f"{FIXTURES}/oversub_freq.npy"))
    return np.stack(cases).astype(np.int32)


def raw_deflate(data: bytes, level: int = 6, wbits: int = -15,
                strategy: int = 0, mem: int = 8, zdict: bytes | None = None,
                ) -> bytes:
    """stdlib zlib's stream of `data` (raw for wbits < 0)."""
    kw = {"zdict": zdict} if zdict else {}
    co = zlib.compressobj(level, zlib.DEFLATED, wbits, mem, strategy, **kw)
    return co.compress(data) + co.flush()


class _Bits:
    """LSB-first DEFLATE bit writer for hand-made streams."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> "_Bits":
        self.bits += [(value >> i) & 1 for i in range(n)]
        return self

    def code(self, code: int, n: int) -> "_Bits":
        """A Huffman code, most significant bit first."""
        self.bits += [(code >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def bytes(self) -> bytes:
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(sum(b[i + j] << j for j in range(8))
                     for i in range(0, len(b), 8))


def _dyn_head(w: _Bits, cl: dict, hlit: int = 257, hdist: int = 1) -> _Bits:
    """Final dynamic block header with code-length code lengths `cl`
    ({symbol: length}), all 19 sent."""
    order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
    w.put(1, 1).put(2, 2).put(hlit - 257, 5).put(hdist - 1, 5).put(15, 4)
    for s in order:
        w.put(cl.get(s, 0), 3)
    return w


def crafted_streams() -> dict:
    """Raw DEFLATE streams that each reach one of zlib's error strings
    (decoded as wbits=15 raw streams)."""
    # CL code {0: '0', 1: '10', 2: '11'}
    cl3 = {0: 1, 1: 2, 2: 2}
    out = {
        "block type 3": b"\x07\x00",
        "stored lengths": b"\x01\x05\x00\x00\x00",
        "too many symbols": bytes([0xFD, 0xFF, 0xFF]),
        "truncated stored": b"\x01\x05\x00\xfa\xffab",
        "empty input": b"",
        # fixed block: literal 'a', then length 3 at distance 4 (too far)
        "distance too far": _Bits().put(1, 1).put(1, 2).code(0x30 + 97, 8)
        .code(1, 7).code(3, 5).code(0, 7).bytes(),
        # fixed block: symbol 286 (code 11000110)
        "invalid literal/length code": _Bits().put(1, 1).put(1, 2)
        .code(0xC6, 8).bytes(),
        # fixed block: length 3, then distance code 30 (11110)
        "invalid distance code": _Bits().put(1, 1).put(1, 2).code(1, 7)
        .code(30, 5).put(0, 16).bytes(),
        # every code-length code of length 1: oversubscribed
        "invalid code lengths set": _dyn_head(_Bits(), dict.fromkeys(
            range(19), 1)).put(0, 16).bytes(),
        # the first code length is a repeat (symbol 16)
        "invalid bit length repeat": _dyn_head(_Bits(), {0: 1, 16: 1})
        .code(1, 1).put(0, 16).bytes(),
    }
    # 258 zero lengths: no end-of-block code
    w = _dyn_head(_Bits(), {0: 1, 1: 1})
    for _ in range(258):
        w.code(0, 1)
    out["missing end-of-block"] = w.put(0, 16).bytes()
    # literal/length lengths {0: 2, 256: 2}: incomplete
    w = _dyn_head(_Bits(), cl3)
    w.code(3, 2)
    for _ in range(255):
        w.code(0, 1)
    out["invalid literal/lengths set"] = w.code(3, 2).code(3, 2).put(
        0, 16).bytes()
    # literal/length lengths {0: 1, 256: 1}, distance lengths {0: 2}
    w = _dyn_head(_Bits(), cl3)
    w.code(2, 2)
    for _ in range(255):
        w.code(0, 1)
    out["invalid distances set"] = w.code(2, 2).code(3, 2).put(
        0, 16).bytes()
    return out
