"""frame.ms_per_MiB: a compress call's framing on the host (the span
`frame`, entered twice: lane geometry, padded buffer, pinning and upload
before the groups; checksum, header and trailer after them; host clock)
in ms per MiB of input, over the window; left out where the program has
no such span."""
from portbench.readers import compress_cuda_calls, stage_ms_per_mib

SPAN = "frame"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(SPAN not in c["stage"] for c in calls):
        return None
    return stage_ms_per_mib(rec, SPAN)
