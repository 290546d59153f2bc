"""decode.host_ms_per_MiB: the decode wave engine's host time outside
phases A and B (total_s - phase_a_s - phase_b_s) in ms per MiB of output,
over the window."""
from portbench.readers import decode_ms_per_mib


def read(rec):
    return decode_ms_per_mib(
        rec, lambda d: d["total_s"] - d["phase_a_s"] - d["phase_b_s"])
