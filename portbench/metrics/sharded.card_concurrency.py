"""sharded.card_concurrency: how many cards the sharded steps keep busy at
once: the device seconds of the per-shard spans (`sharded.stage1.shard`
and `sharded.stage2.shard`, CUDA events on each shard's card) over the
host seconds of the steps around them (`sharded.stage1` and
`sharded.stage2`), summed over the window. 1.0 when the shards run one
after another, the card count when they overlap fully; left out where the
program has no such spans."""
from portbench.readers import compress_cuda_calls

DEVICE = ("sharded.stage1.shard", "sharded.stage2.shard")
HOST = ("sharded.stage1", "sharded.stage2")


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(k not in c["stage"] for c in calls
                        for k in DEVICE + HOST):
        return None
    host = sum(c["stage"][k] for c in calls for k in HOST)
    if not host:
        return None
    return sum(c["stage"][k] for c in calls for k in DEVICE) / host
