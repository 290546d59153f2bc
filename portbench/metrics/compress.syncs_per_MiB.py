"""compress.syncs_per_MiB: the times a compress call's host waited for the
card (fetches, uploads from pageable memory, scalar reads, nonzero, the
closing synchronize: the program's counter `syncs.n`) per MiB of input,
over the window; left out where the program has no such counter."""
from portbench.readers import MIB, compress_cuda_calls

COUNTER = "syncs.n"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(COUNTER not in c["stage"] for c in calls):
        return None
    mib = sum(c["bytes_in"] for c in calls) / MIB
    return sum(c["stage"][COUNTER] for c in calls) / mib
