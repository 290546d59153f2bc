"""decode.syncs_per_MiB: the times a decode's host waited for the card
(uploads from pageable memory, fetches, the pointer doubling's
convergence reads, the closing synchronize: the program's counter
`syncs`) per MiB of output, over the window; left out where the program
has no such counter."""
from portbench.readers import MIB, decode_calls

COUNTER = "syncs"


def read(rec):
    calls = decode_calls(rec)
    if not calls or any(COUNTER not in c["decode"] for c in calls):
        return None
    mib = sum(c["bytes_out"] for c in calls) / MIB
    return sum(c["decode"][COUNTER] for c in calls) / mib
