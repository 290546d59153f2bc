"""decode.k2_roofline: K2 on decode phase A's bit steps (`csrc/parse.cu`,
kernels `parse_speculate` and `parse_stitch`) as a share of its byte
bound at 3.35 TB/s over their profiled device time, in %. The bytes are
`geometry.k2_bytes(sum B, sum B*N / sum B)`, 5 * sum B*N + 8 * sum B, over
the step arrays phase A handed K2 (the program's counters `k2_lanes` and
`k2_positions`), taken per MiB of output over the window and scaled to
the traced calls' output: every call decodes the same archive. Left out
unless the profiler's parse_speculate and parse_stitch counts both equal
the program's K2 launches per call (`phase_a`: one per dispatch on a
card) times the traced calls."""
from portbench import geometry
from portbench.readers import decode_calls, device_profile, kernel_time


def read(rec):
    p = device_profile(rec, "decode")
    calls = decode_calls(rec)
    if p is None or not calls or not p["bytes_out"] or any(
            "k2_lanes" not in c["decode"] for c in calls):
        return None
    launches = {c["decode"]["phase_a"] for c in calls}
    outs = {c["bytes_out"] for c in calls}
    if len(launches) != 1 or len(outs) != 1:
        return None
    traced, rest = divmod(p["bytes_out"], outs.pop())
    n1, s1 = kernel_time(p, "parse_speculate")
    n2, s2 = kernel_time(p, "parse_stitch")
    if rest or not (s1 + s2) or not n1 == n2 == launches.pop() * traced:
        return None
    scale = p["bytes_out"] / sum(c["bytes_out"] for c in calls)
    lanes = scale * sum(c["decode"]["k2_lanes"] for c in calls)
    positions = scale * sum(c["decode"]["k2_positions"] for c in calls)
    need = geometry.k2_bytes(lanes, positions / lanes)
    return 100.0 * need / geometry.HBM_BYTES_PER_S / (s1 + s2)
