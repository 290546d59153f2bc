"""stitch.fetch_ms_per_MiB: the stitch's fetch of each group's packed
bytes (the wait for the group's stage 2, then the copy to the host: the
span `stitch.fetch`, host clock) in ms per MiB of input, over the window;
left out where the program has no such span."""
from portbench.readers import compress_cuda_calls, stage_ms_per_mib

SPAN = "stitch.fetch"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(SPAN not in c["stage"] for c in calls):
        return None
    return stage_ms_per_mib(rec, SPAN)
