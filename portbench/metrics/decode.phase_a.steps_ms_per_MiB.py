"""decode.phase_a.steps_ms_per_MiB: decode phase A's per-bit decode of
every lane, after the LUTs (the program's span `phase_a.steps`, device
time between CUDA events, `ops/inflate.py:decode_stats[
"phase_a.steps_s"]`) in ms per MiB of output, over the window; left out
where the program has no such span."""
from portbench.readers import decode_calls, decode_ms_per_mib

KEY = "phase_a.steps_s"


def read(rec):
    calls = decode_calls(rec)
    if not calls or any(KEY not in c["decode"] for c in calls):
        return None
    return decode_ms_per_mib(rec, lambda d: d[KEY])
