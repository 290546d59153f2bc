"""Strategy constants and the level table of the compression path.

`LEVELS` parameterizes one match engine for every level (zlib-ng
configuration_table, deflate.c:142-168), equal to `zlibng_tpu/stream/
deflate.py:LEVELS`.
"""
from __future__ import annotations

from dataclasses import dataclass

# strategies (zlib-ng.h.in:199-203)
Z_DEFAULT_STRATEGY = 0
Z_FILTERED = 1
Z_HUFFMAN_ONLY = 2
Z_RLE = 3
Z_FIXED = 4


@dataclass(frozen=True)
class LevelConfig:
    chain: int
    lazy: bool
    max_lazy: int
    nice: int
    # good_length analog (deflateTune `good`): after the first 16 probes,
    # positions whose best probe already reaches `good` bytes (capped at
    # the 16-byte probe width) stop improving
    good: int = 12


LEVELS = {
    1: LevelConfig(2, False, 4, 16, good=8),
    2: LevelConfig(4, False, 5, 16, good=8),
    3: LevelConfig(8, False, 6, 32, good=8),
    4: LevelConfig(8, True, 16, 64, good=8),
    5: LevelConfig(16, True, 16, 64, good=10),
    6: LevelConfig(16, True, 32, 128, good=12),
    7: LevelConfig(32, True, 32, 128, good=12),
    8: LevelConfig(48, True, 64, 258, good=12),
    9: LevelConfig(64, True, 258, 258, good=12),
}


def level_config_from(obj) -> LevelConfig:
    """The port's LevelConfig from any object with `chain`, `lazy`,
    `max_lazy`, `nice` and `good` (e.g. a deflateTune setting)."""
    return LevelConfig(int(obj.chain), bool(obj.lazy), int(obj.max_lazy),
                       int(obj.nice), int(obj.good))
