"""decode.phase_b_ms_per_MiB: decode phase B (`decode_stats["phase_b_s"]`)
in ms per MiB of output, over the window."""
from portbench.readers import decode_ms_per_mib


def read(rec):
    return decode_ms_per_mib(rec, lambda d: d["phase_b_s"])
