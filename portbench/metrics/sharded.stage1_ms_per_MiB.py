"""sharded.stage1_ms_per_MiB: the sharded stage 1 (span `sharded.stage1`,
host clock: from the first shard's enqueue of LZ77, K1, K2 and the lane
histograms to the gathered histograms, with one device span
`sharded.stage1.shard` per shard under it) in ms per MiB of input, over
the window; left out where the program has no such span."""
from portbench.readers import compress_cuda_calls, stage_ms_per_mib

SPAN = "sharded.stage1"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(SPAN not in c["stage"] for c in calls):
        return None
    return stage_ms_per_mib(rec, SPAN)
