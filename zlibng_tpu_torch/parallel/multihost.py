"""Multi-process sharded compression and decode over torch.distributed.

Counterpart of `zlibng_tpu/parallel/multihost.py`. Every process is one rank
of the default process group and holds its own shards (its card under NCCL,
the CPU under gloo, or the `devices` it passes); the same sharded pipeline
as one process (`parallel/sharded.py`) runs with lanes and segments split
across every rank's shards. Only the placement seam differs: `Shards.gather`
is a `torch.distributed.all_gather`. Every rank assembles the zlib stream
with the exact adler32 combine, and rank 0 returns it; decoded segments
reach every rank.

The caller initialises the group first, one rank per process, for example
`torch.distributed.init_process_group("gloo", init_method=
"tcp://127.0.0.1:<port>", rank=r, world_size=n)`; every rank must hold the
same number of shards.
"""
from __future__ import annotations

import torch.distributed as dist

from .sharded import compress_multichip, decompress_segments_multichip


def multihost_compress(data: bytes, lane_block: int = 1 << 16,
                       level: int = 6, devices=None) -> bytes | None:
    """One-shot zlib compression over the shards of every rank. Returns the
    stream on rank 0 and None elsewhere; the bytes equal the reference's
    `compress_multichip` on a mesh of as many devices as there are shards in
    all."""
    z = compress_multichip(bytes(data), devices, level=level,
                           lane_block=lane_block, group=dist.group.WORLD)
    return z if dist.get_rank() == 0 else None


def multihost_decompress_segments(blob: bytes, start_bytes,
                                  devices=None) -> list[bytes]:
    """Sharded decode of indexed full-flush segments across every rank's
    shards. Returns the decoded segments on every rank."""
    return decompress_segments_multichip(bytes(blob), start_bytes, devices,
                                         group=dist.group.WORLD)
