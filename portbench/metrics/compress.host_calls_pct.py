"""compress.host_calls_pct: the window's compress_cuda calls that took the
host route (the program's counter `compress.calls.host`) as a share of
all calls that returned, in %; left out unless every call counted its
route (`compress.calls.host` or `compress.calls.card`)."""
from portbench.readers import compress_cuda_calls

HOST, CARD = "compress.calls.host.n", "compress.calls.card.n"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(HOST not in c["stage"] and CARD not in c["stage"]
                        for c in calls):
        return None
    return 100.0 * sum(c["stage"].get(HOST, 0) for c in calls) / len(calls)
