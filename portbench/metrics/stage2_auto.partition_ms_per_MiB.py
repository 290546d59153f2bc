"""stage2_auto.partition_ms_per_MiB: stage 2 auto's partition (the node
pyramid, the cost estimate with its round trip through the host, the DP,
the walk down: the program's span `stage2.partition`, device time between
CUDA events, `ops/deflate.py:stage_seconds`) in ms per MiB of input, over
the window; left out where the program has no such span."""
from portbench.readers import compress_cuda_calls, stage_ms_per_mib

SPAN = "stage2.partition"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(SPAN not in c["stage"] for c in calls):
        return None
    return stage_ms_per_mib(rec, SPAN, quick=False)
