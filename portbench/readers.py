"""Arithmetic shared by the metric readers in `portbench/metrics/`.

A reader takes the run's record (see `harness.run_cell`) and returns its
number, or None where the run has nothing for it to read: then the
metric is left out of the result line.
"""
from __future__ import annotations

MIB = 1 << 20


def compress_cuda_calls(rec: dict) -> list:
    """The window's compress_cuda calls that returned, with their stage
    clocks."""
    return [c for c in rec["calls"] if c.get("stage") and c["err"] is None]


def decode_calls(rec: dict) -> list:
    """The window's decode calls that returned, with their phase split."""
    return [c for c in rec["calls"] if c.get("decode") and c["err"] is None]


def stage_ms_per_mib(rec: dict, stage: str, quick=None):
    """Milliseconds of one compress stage per MiB of input, summed over
    the window; `quick` True or False keeps only that stage 2 path."""
    if quick is not None and rec["codec"].get("quick") is not quick:
        return None
    calls = compress_cuda_calls(rec)
    mib = sum(c["bytes_in"] for c in calls) / MIB
    if not mib:
        return None
    return 1e3 * sum(c["stage"][stage] for c in calls) / mib


def decode_ms_per_mib(rec: dict, part) -> object:
    """Milliseconds of one decode part per MiB of output over the window;
    `part` maps a call's decode_stats to seconds."""
    calls = decode_calls(rec)
    mib = sum(c["bytes_out"] for c in calls) / MIB
    if not mib:
        return None
    return 1e3 * sum(part(c["decode"]) for c in calls) / mib


def device_profile(rec: dict, kind: str):
    """The traced part's summary when the run profiled a card and its
    requests are judged as `kind` (`compress` or `decode`)."""
    p = rec.get("profile")
    if not p or not p.get("busy_by_card") or not p.get("window_s"):
        return None
    if rec["judged_as"] != kind:
        return None
    return p


def idle_pct(rec: dict, kind: str):
    p = device_profile(rec, kind)
    if p is None:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def kernels_per_mib(rec: dict, kind: str, side: str):
    p = device_profile(rec, kind)
    if p is None or not p[side]:
        return None
    return p["device_events"] / (p[side] / MIB)


def kernel_time(p: dict, marker: str) -> tuple[int, float]:
    """Launches and device seconds of the kernels whose name holds
    `marker`."""
    hits = [v for n, v in p["by_name"].items() if marker in n]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)
