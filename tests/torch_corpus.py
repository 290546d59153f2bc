"""In-repo corpora for the PyTorch port's parity tests (tests/test_torch_*.py).

Only files under tests/fixtures and seeded synthetic bytes: the port's
tests read nothing outside the repository.
"""
import functools
import gzip
import os

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
