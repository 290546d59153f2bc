"""stage2.render_ms_per_MiB: stage 2's render (table select, demotion and
token render up to the pack, on the auto and the quick path: the span
`stage2.render`, device time) in ms per MiB of input, over the window;
left out where the program has no such span."""
from portbench.readers import compress_cuda_calls, stage_ms_per_mib

SPAN = "stage2.render"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(SPAN not in c["stage"] for c in calls):
        return None
    return stage_ms_per_mib(rec, SPAN)
