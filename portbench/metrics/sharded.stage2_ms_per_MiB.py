"""sharded.stage2_ms_per_MiB: the sharded stage 2 (span `sharded.stage2`,
host clock: from the first shard's enqueue of render, pack and lane
adler32 to the gathered sizes and checksums, with one device span
`sharded.stage2.shard` per shard under it) in ms per MiB of input, over
the window; left out where the program has no such span."""
from portbench.readers import compress_cuda_calls, stage_ms_per_mib

SPAN = "sharded.stage2"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(SPAN not in c["stage"] for c in calls):
        return None
    return stage_ms_per_mib(rec, SPAN)
