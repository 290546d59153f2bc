"""decode.phase_a.k2_ms_per_MiB: decode phase A's walk over the bit steps
(`parse_select`, K2 on a card: the program's span `phase_a.k2`, device
time between CUDA events, `ops/inflate.py:decode_stats["phase_a.k2_s"]`)
in ms per MiB of output, over the window; left out where the program has
no such span."""
from portbench.readers import decode_calls, decode_ms_per_mib

KEY = "phase_a.k2_s"


def read(rec):
    calls = decode_calls(rec)
    if not calls or any(KEY not in c["decode"] for c in calls):
        return None
    return decode_ms_per_mib(rec, lambda d: d[KEY])
