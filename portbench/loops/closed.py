"""Loop `closed`: one client that sends each request when the last one
has returned, until `seconds` have passed. The window ends when the last
request returns, so a rate over it counts all of its work and time."""
from __future__ import annotations

import time


def drive(send, requests, seconds: float) -> tuple[list, float]:
    """Sends `next(requests)` through `send(req) -> record` until the
    window is over. Returns the records, each with its latency `s`, and
    the window's length in seconds."""
    recs = []
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < seconds:
        req = next(requests)
        t0 = time.perf_counter()
        rec = send(req)
        t_end = time.perf_counter()
        rec["s"] = t_end - t0
        recs.append(rec)
    return recs, t_end - t_start
