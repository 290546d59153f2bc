"""decode.phase_a.compact_ms_per_MiB: decode phase A's rank-scatter
compaction of the walk's tokens and the first-EOB scan (the program's
span `phase_a.compact`, device time between CUDA events,
`ops/inflate.py:decode_stats["phase_a.compact_s"]`) in ms per MiB of
output, over the window; left out where the program has no such span."""
from portbench.readers import decode_calls, decode_ms_per_mib

KEY = "phase_a.compact_s"


def read(rec):
    calls = decode_calls(rec)
    if not calls or any(KEY not in c["decode"] for c in calls):
        return None
    return decode_ms_per_mib(rec, lambda d: d[KEY])
