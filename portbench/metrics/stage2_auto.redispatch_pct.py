"""stage2_auto.redispatch_pct: stage 2 auto's groups redone after their
exact bits overflowed the chosen output bucket, over the groups
dispatched (the program's counters `stage2.redispatch.n` and
`stage2.groups.n`), in %, over the window. Read where the run profiled a
card; left out in a CPU run (whose dry-run test wants every metric above
0, and 0 is this share's usual reading) and where the program has no such
counters."""
from portbench.readers import compress_cuda_calls, device_profile

REDONE, GROUPS = "stage2.redispatch.n", "stage2.groups.n"


def read(rec):
    calls = compress_cuda_calls(rec)
    if device_profile(rec, "compress") is None or not calls or any(
            GROUPS not in c["stage"] for c in calls):
        return None
    groups = sum(c["stage"][GROUPS] for c in calls)
    if not groups:
        return None
    return 100.0 * sum(c["stage"][REDONE] for c in calls) / groups
