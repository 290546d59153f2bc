"""decode.phase_a.retry_pct: phase A lanes sent again in a bigger lane
bucket (their block outgrew the lane or its token array), over the real
lanes dispatched (the program's counters `phase_a_retries` and
`phase_a_lanes`), in %, over the window. Read where the run profiled a
card; left out in a CPU run (whose dry-run test wants every metric above
0, and 0 is this share's usual reading) and where the program has no such
counters."""
from portbench.readers import decode_calls, device_profile

RETRIES, LANES = "phase_a_retries", "phase_a_lanes"


def read(rec):
    calls = decode_calls(rec)
    if device_profile(rec, "decode") is None or not calls or any(
            LANES not in c["decode"] for c in calls):
        return None
    lanes = sum(c["decode"][LANES] for c in calls)
    if not lanes:
        return None
    return 100.0 * sum(c["decode"][RETRIES] for c in calls) / lanes
