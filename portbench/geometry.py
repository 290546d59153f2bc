"""The yardstick's frozen copy of the port's lane geometry, and the byte
bounds of its two hand-written kernels.

Copied from `zlibng_tpu_torch/ops/deflate.py` (LANE_HIST, LANE_BLOCKS,
GROUP_BYTES, the lane-size rule, the group loop and its power-of-two lane
padding), `ops/lz77.py` (PROBE_WORDS, DENSE_PROBES) and
`stream/deflate.py` (each level's chain), so that a later change to the
program cannot move the bytes a roofline share is counted from. The
benchmark checks the launches this geometry implies against the program's
launch counters and the profiler's kernel count, and leaves a roofline
out where they disagree.
"""
from __future__ import annotations

LANE_HIST = 32768
LANE_BLOCKS = (1 << 16, 1 << 17, 1 << 18)
GROUP_BYTES = 1 << 21
PROBE_WORDS = 4
DENSE_PROBES = 64
# each level's chain (stream/deflate.py:LEVELS); levels beyond 1..9 clamp
CHAIN = {1: 2, 2: 4, 3: 8, 4: 8, 5: 16, 6: 16, 7: 32, 8: 48, 9: 64}
Z_HUFFMAN_ONLY, Z_RLE, Z_FIXED = 2, 3, 4
# one H100 SXM's HBM3 bandwidth (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12


def lane_block(n: int) -> int:
    """Payload bytes per lane for an n-byte input: the fewest processed
    positions (history prefix plus zero tail), ties to bigger lanes."""
    return min(LANE_BLOCKS, key=lambda lb: (-(-n // lb) * (lb + LANE_HIST),
                                            -lb))


def quick(level: int, strategy: int) -> bool:
    """Whether stage 2 takes the fixed-tree quick path."""
    return strategy == Z_FIXED or (level == 1 and strategy == 0)


def stage1_groups(n: int, level: int, strategy: int = 0) -> list:
    """(B, N) of each lane group's stage 1 in one compress_cuda call of n
    bytes: B lanes (padded to a power of two) of N = LANE_HIST + lane
    positions. Level 0 and inputs under 1024 bytes run on the host."""
    if level == 0 or n < 1024:
        return []
    lb = lane_block(n)
    max_lanes = max(1, GROUP_BYTES // lb)
    nblocks = max(1, -(-n // lb))
    return [(1 << (min(max_lanes, nblocks - g0) - 1).bit_length(),
             LANE_HIST + lb) for g0 in range(0, nblocks, max_lanes)]


def k1_launches(n: int, level: int, strategy: int = 0) -> list:
    """(B, N, deep) of each K1 launch: one per group, none for the
    strategies that take no probes; deep when the chain passes the dense
    probes."""
    if strategy in (Z_HUFFMAN_ONLY, Z_RLE):
        return []
    deep = CHAIN[max(1, min(9, level))] > DENSE_PROBES
    return [(B, N, deep) for B, N in stage1_groups(n, level, strategy)]


def k2_launches(n: int, level: int, strategy: int = 0) -> list:
    """(B, N) of each K2 launch of the encode parse: one per group."""
    return stage1_groups(n, level, strategy)


def k1_bytes(B: int, N: int, deep: bool, W: int = PROBE_WORDS) -> int:
    """K1's traffic (`chip_smoke.py:_k1_bytes`): each row's W + 2 int32
    planes read once and its two int32 results written once, plus
    hist_valid_from (and enc_end for the deep probes)."""
    return B * N * ((W + 2) * 4 + 8) + 4 * B * (2 if deep else 1)


def k2_bytes(B: int, N: int) -> int:
    """K2's traffic on the encode parse: the int32 step array and the
    (B, 2) int32 bounds read once, the (B, N) bool mask written once."""
    return 5 * B * N + 8 * B
