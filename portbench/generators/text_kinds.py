"""Data generator `text_kinds`: the text that opens `mixed_kinds`.

The first 4,855,137 B of `mixed_kinds.corpus(seed)`: the unpacked pigz
2.6 source tarball (C sources, man page, makefile), the two text fixtures
(`test.txt`, `default.txt`) and 4 MiB of skewed-word text. It stands for
the `text/html` bodies that nginx's gzip filter compresses by default
(`gzip_types`), since no HTML corpus is in the repository. The length is
the same at every seed, and only the skewed-word text depends on it.
"""
from __future__ import annotations

from portbench.generators.mixed_kinds import MASK64, corpus

TEXT_BYTES = 4_855_137


def make(seed: int) -> bytes:
    return corpus(seed & MASK64)[:TEXT_BYTES]
