"""stage2.pack_ms_per_MiB: stage 2's pack (`hierarchical_pack` of bodies
and headers and `_compact_units`, on both paths: the span `stage2.pack`,
device time) in ms per MiB of input, over the window; left out where the
program has no such span."""
from portbench.readers import compress_cuda_calls, stage_ms_per_mib

SPAN = "stage2.pack"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(SPAN not in c["stage"] for c in calls):
        return None
    return stage_ms_per_mib(rec, SPAN)
