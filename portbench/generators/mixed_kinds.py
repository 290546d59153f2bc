"""Data generator `mixed_kinds`: a frozen copy of `chip_smoke.py:corpus`.

A buffer of mixed kinds: three small real files (the pigz 2.6 source
tarball, unpacked, and two text fixtures; copies of the repository's test
fixtures, kept in `portbench/data/` so that the yardstick does not move
when the tests' files do), then splitmix64 text, uniform and 16-symbol
bytes, little-endian counters, byte runs and zeros. No public corpus
defines this mix: it is the repository's own stand-in until real corpus
files are in the repository. Integer arithmetic only, so every machine
and NumPy version makes the same bytes. Every part has the same length at
every seed, so every seed gives the same amount and mix of work.

Parameters: `mib` (default 8.5), the buffer's length in MiB.
"""
from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent.parent / "data"
MASK64 = (1 << 64) - 1


def rand64(seed: int, stream: int, n: int) -> np.ndarray:
    """n pseudo-random uint64 (splitmix64 over a counter)."""
    with np.errstate(over="ignore"):
        z = ((np.arange(n, dtype=np.uint64) + np.uint64(stream << 40))
             * np.uint64(0x9E3779B97F4A7C15) + np.uint64(seed & MASK64))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def corpus(seed: int, mib: float = 8.5) -> bytes:
    """The corpus at `seed`: byte for byte `chip_smoke.corpus(seed, mib)`."""
    parts = [
        gzip.decompress((DATA / "pigz-2.6.tar.gz").read_bytes()),
        (DATA / "test.txt").read_bytes(),
        (DATA / "default.txt").read_bytes(),
    ]
    # text: words from a 6000-word vocabulary (letters skewed toward the
    # common ones), ranks skewed toward the first words, with punctuation
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    skew = np.repeat(np.arange(26), np.arange(26, 0, -1))    # 351 slots
    r = rand64(seed, 0, 6000 * 11)
    lens = 2 + (r[:6000] % np.uint64(9)).astype(np.int64)
    picks = letters[skew[(r[6000:] % np.uint64(skew.size)).astype(np.int64)]]
    vocab = [picks[10 * i: 10 * i + n].tobytes() for i, n in enumerate(lens)]
    r = rand64(seed, 1, 2 * 900_000)
    ranks = ((r[:900_000] % np.uint64(6000))
             >> (r[900_000:] % np.uint64(12))).astype(np.int64)
    seps = [b" ", b" ", b" ", b" ", b", ", b". ", b".\n"]
    sep_i = (rand64(seed, 2, ranks.size) % np.uint64(7)).astype(np.int64)
    text = b"".join(vocab[w] + seps[i]
                    for w, i in zip(ranks.tolist(), sep_i.tolist()))
    parts.append(text[: 4 << 20])
    r = rand64(seed, 3, 1 << 20)
    parts.append((r & np.uint64(0xFF)).astype(np.uint8).tobytes())
    parts.append((r >> np.uint64(60)).astype(np.uint8).tobytes())
    steps = (rand64(seed, 4, 1 << 17) % np.uint64(300)).astype(np.uint32)
    parts.append(np.cumsum(steps, dtype=np.uint32).astype("<u4").tobytes())
    r = rand64(seed, 5, 1 << 14)
    reps = 1 + ((r >> np.uint64(8)) % np.uint64(79)).astype(np.int64)
    runs = np.repeat((r & np.uint64(0xFF)).astype(np.uint8), reps)
    parts.append(runs.tobytes()[: 512 << 10])
    used = sum(len(p) for p in parts)
    parts.append(bytes(max(0, int(mib * (1 << 20)) - used)))
    return b"".join(parts)


def make(seed: int, mib: float = 8.5) -> bytes:
    return corpus(seed & MASK64, mib)
