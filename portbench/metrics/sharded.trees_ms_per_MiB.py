"""sharded.trees_ms_per_MiB: the sharded path's trees on the host (span
`sharded.trees`, host clock: the cost prepass, each lane's
`huffman_table` and `build_dynamic_header`, and the stored, static or
dynamic choice) in ms per MiB of input, over the window; left out where
the program has no such span."""
from portbench.readers import compress_cuda_calls, stage_ms_per_mib

SPAN = "sharded.trees"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(SPAN not in c["stage"] for c in calls):
        return None
    return stage_ms_per_mib(rec, SPAN)
