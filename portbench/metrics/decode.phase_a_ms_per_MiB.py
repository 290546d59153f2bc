"""decode.phase_a_ms_per_MiB: decode phase A (the program's host clock,
closed by a fetch: `ops/inflate.py:decode_stats["phase_a_s"]`) in ms per
MiB of output, over the window."""
from portbench.readers import decode_ms_per_mib


def read(rec):
    return decode_ms_per_mib(rec, lambda d: d["phase_a_s"])
