"""Data generator `mixed_kinds_joined`: `parts` buffers of `mixed_kinds`
joined end to end, one file of the size a pigz user compresses in parts.

Part i is made at seed `seed * parts + i`, so no two seeds share a part,
and every part has the same length, so that each of `parts` equal shards
of the whole (one per card) is one whole mix. At the defaults the result
is 35,651,584 B at every seed.

Parameters: `parts` (default 4), `mib` (default 8.5), each part's length
in MiB.
"""
from __future__ import annotations

from portbench.generators.mixed_kinds import MASK64, corpus


def make(seed: int, parts: int = 4, mib: float = 8.5) -> bytes:
    return b"".join(corpus((seed * parts + i) & MASK64, mib)
                    for i in range(parts))
