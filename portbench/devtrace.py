"""The traced part of a `--trace 1` run: a bounded number of requests
under torch.profiler, each inside a `portbench.call` range, reduced to
what the per-layer metrics and the breakdown read.

The device's busy time is the union of its device intervals (kernels,
copies, fills) inside the profiled window, per card; overlapping events
count once. An idle gap is time inside the window in which no card ran
anything, named by the innermost host operation that was running at its
middle on the thread that made the calls.
"""
from __future__ import annotations

import time

LABEL = "portbench.call"
TOP = 10


def run(calls: list, cuda_indices: list) -> tuple[list, dict]:
    """Runs each zero-argument callable of `calls` once under the
    profiler. Returns each call's (answer or None, error text or None,
    host seconds) and the reduced trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if cuda_indices:
        acts.append(ProfilerActivity.CUDA)
    done = []
    with profile(activities=acts) as prof:
        for fn in calls:
            with record_function(LABEL):
                t0 = time.perf_counter()
                try:
                    out, err = fn(), None
                except Exception as e:        # judged as a failed call
                    out, err = None, repr(e)
                done.append((out, err, time.perf_counter() - t0))
        for i in cuda_indices:
            torch.cuda.synchronize(i)
    return done, reduce(_events(prof), cuda_indices)


def _events(prof) -> list:
    """(name, on_device, device_index, start_ns, end_ns, thread) of every
    event of the profiler's kineto results, the device's own annotations
    of host ranges left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == cuda
        if on_dev and e.is_user_annotation():
            continue
        t0 = e.start_ns()
        out.append((e.name(), on_dev, e.device_index(), t0,
                    t0 + e.duration_ns(), e.start_thread_id()))
    return out


def _union(iv: list) -> list:
    """Sorted, merged [start, end] of possibly overlapping intervals."""
    iv = sorted(iv)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(events: list, cuda_indices: list) -> dict:
    """The traced window (first to last `portbench.call` range), busy
    seconds per card, device events and time by name, the top device
    operations and the idle gaps by host activity."""
    calls = [e for e in events if e[0] == LABEL and not e[1]]
    if not calls:
        return {}
    w0 = min(e[3] for e in calls)
    w1 = max(e[4] for e in calls)
    tid = calls[0][5]
    dev = [e for e in events if e[1] and e[0] != LABEL
           and e[4] > w0 and e[3] < w1]
    by_name: dict[str, list] = {}
    per_card: dict[int, list] = {}
    for name, _, idx, a, b, _ in dev:
        acc = by_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += (b - a) / 1e9
        per_card.setdefault(idx, []).append((max(a, w0), min(b, w1)))
    busy = {i: sum(b - a for a, b in _union(per_card.get(i, []))) / 1e9
            for i in cuda_indices}
    # idle gaps: where no card ran anything
    merged = _union([iv for ivs in per_card.values() for iv in ivs])
    gaps, at = [], w0
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < w1:
        gaps.append((at, w1))
    host = sorted((e for e in events if not e[1] and e[5] == tid),
                  key=lambda e: (e[3], -e[4]))
    idle: dict[str, float] = {}
    stack, j = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2
        while j < len(host) and host[j][3] <= mid:
            while stack and stack[-1][4] <= host[j][3]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][4] <= mid:
            stack.pop()
        what = stack[-1][0] if stack else "no host operation"
        if what == LABEL:
            what = "host code between operations"
        idle[what] = idle.get(what, 0.0) + (g1 - g0) / 1e9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return dict(
        window_s=(w1 - w0) / 1e9,
        busy_s=(sum(busy.values()) / len(busy)) if busy else 0.0,
        busy_by_card=busy,
        device_events=len(dev),
        by_name=by_name,
        device_ops=[[n[:200], v[1]] for n, v in top_ops],
        idle_gaps=[[n[:200], s] for n, s in
                   sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]])
