"""host_encode.ms_per_MiB: compress_cuda's host route (level 0 and inputs
under 1,024 B: the span `host_encode`, host clock, checksum and framing
included) in ms per MiB of all input of the window's calls; left out
where no call has such a span."""
from portbench.readers import MIB, compress_cuda_calls

SPAN = "host_encode"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not any(SPAN in c["stage"] for c in calls):
        return None
    mib = sum(c["bytes_in"] for c in calls) / MIB
    return 1e3 * sum(c["stage"].get(SPAN, 0.0) for c in calls) / mib
