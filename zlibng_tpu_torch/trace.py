"""The port's one span-and-counter facility, and its opt-in trace lines
(the ZLIB_DEBUG Trace/Tracev analog, zutil.h:100-120).

A public call (a compress, a decode) opens a root with `call()`: the root
takes the next call id, and the spans opened on its thread while it is
open nest under it through a per-thread stack. A span records its name,
its parent, its ids (`group=g` for a lane group, `wave=w` for a decode
wave), its host start and end (`perf_counter_ns`) and, for device work on
a card, a pair of CUDA events on `torch.cuda.current_stream(dev)` of the
device its tensors live on. `count(name, n)` adds to the call's counters.

Every wait of the host for a device goes through one helper, `_wait`,
under the names `fetch` (a device-to-host copy), `item` (a device
scalar's value), `nonzero`, `upload` (a copy from pageable host memory)
and `synchronize`: each counts `syncs`, adds the bytes it copies to
`sync_bytes`, times the wait as the child span `<parent>.fetch`, and does
the same wait as the code it stands for. The counts are the same on the
CPU, where the waits cost nothing.

The root reads the events once, when it closes: it synchronizes each card
that has events (one more counted wait; the event's reads follow it) and
hands the record (`Call`) to the callbacks that fill the views
(`ops/deflate.py:stage_seconds`, `ops/inflate.py:decode_stats`). Outside
a call, a span or a counter costs one check and records nothing.

While torch.profiler is active, each span also opens the range
`zng.<name>` (record_function), so the profiler's trace names the spans
on its own clock; with no profiler, that costs one boolean check.

Trace lines are on under the ZLIBNG_TPU_TRACE environment variable (any
non-empty value other than "0") or after enable(); they go to stderr
unless enable(sink=fn) redirects them. A root writes one line per span
when it closes: label, call id, ids, parent, host ms and, on a card,
device ms; labels are formatted only then. `trace()` writes one line at
once.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _profiler

_enabled = os.environ.get("ZLIBNG_TPU_TRACE", "") not in ("", "0")
_sink = None
_local = threading.local()
_call_ids = itertools.count(1)
_NOTHING = contextlib.nullcontext()


def enabled() -> bool:
    return _enabled


def enable(on: bool = True, sink=None) -> None:
    """Turn tracing on/off at runtime (the z_verbose analog); optional
    sink(line: str) replaces the stderr writer."""
    global _enabled, _sink
    _enabled = on
    _sink = sink


def trace(fmt: str, *args) -> None:
    if _enabled:
        _write([fmt % args if args else fmt])


def _write(texts: list) -> None:
    """Each text as one line, to the sink or in one write to stderr."""
    lines = ["[zlibng_tpu_torch] " + t for t in texts]
    if _sink is not None:
        for line in lines:
            _sink(line)
    else:
        print("\n".join(lines), file=sys.stderr, flush=True)


class Span:
    """One timed piece of a call; a context manager that nests it under
    the innermost open span of its call."""

    __slots__ = ("call", "name", "ids", "parent", "index", "t0", "t1",
                 "dev", "events", "device_s", "_range")

    def __init__(self, call: "Call", name: str, device, ids: dict):
        self.call, self.name, self.ids = call, name, ids
        self.dev = None
        if device is not None and device.type == "cuda":
            # one key per card: "cuda" is the current card
            self.dev = device if device.index is not None else torch.device(
                "cuda", torch.cuda.current_device())
        self.parent = self.events = self.device_s = self._range = None
        self.t0 = self.t1 = 0

    def __enter__(self):
        call = self.call
        self.parent = call.stack[-1] if call.stack else None
        self.index = len(call.spans)
        call.spans.append(self)
        call.stack.append(self)
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function("zng." + self.name)
            self._range.__enter__()
        if self.dev is not None:
            a = torch.cuda.Event(enable_timing=True)
            a.record(torch.cuda.current_stream(self.dev))
            self.events = (a, None)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.dev is not None:
            b = torch.cuda.Event(enable_timing=True)
            b.record(torch.cuda.current_stream(self.dev))
            self.events = (self.events[0], b)
        self.call.stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False

    @property
    def host_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def seconds(self) -> float:
        """Device seconds for a span of device work on a card, else host
        seconds."""
        return self.device_s if self.device_s is not None else self.host_s

    def label(self) -> str:
        ids = "".join(f" {k}={v}" for k, v in self.ids.items())
        parent = (f" parent={self.parent.name}#{self.parent.index}"
                  if self.parent is not None else "")
        dev = (f" device={1e3 * self.device_s:.3f} ms"
               if self.device_s is not None else "")
        return (f"{self.name}#{self.index} call={self.call.id}{ids}{parent}"
                f" host={1e3 * self.host_s:.3f} ms{dev}")


class Call:
    """The record of one public call: its spans in the order they opened
    and its counters."""

    def __init__(self, name: str, publish):
        self.id = next(_call_ids)
        self.name = name
        self.spans: list[Span] = []
        self.stack: list[Span] = []
        self.counts: dict[str, int] = {"syncs": 0, "sync_bytes": 0}
        self.publish = [publish]

    def totals(self) -> dict:
        """Seconds summed by span name (device time where there is)."""
        out: dict[str, float] = {}
        for sp in self.spans:
            out[sp.name] = out.get(sp.name, 0.0) + sp.seconds
        return out

    def _read_events(self, finished: bool) -> None:
        """Device seconds of every span with events. A call that finished
        waits for each of its cards first; one cut by an error reads only
        the spans whose work is done, and waits for nothing."""
        timed = [sp for sp in self.spans if sp.events is not None
                 and sp.events[1] is not None]
        if finished:
            for dev in dict.fromkeys(sp.dev for sp in timed):
                synchronize(dev)
        for sp in timed:
            a, b = sp.events
            if finished or b.query():
                sp.device_s = a.elapsed_time(b) / 1e3


@contextlib.contextmanager
def call(name: str, publish):
    """Root of one public call; `publish(call)` runs once it has closed.
    Entered inside another call on the same thread, it adds `publish` to
    that call and opens nothing: the outer root closes both."""
    outer = getattr(_local, "call", None)
    if outer is not None:
        if publish not in outer.publish:
            outer.publish.append(publish)
        yield outer
        return
    c = Call(name, publish)
    _local.call = c
    finished = False
    try:
        with Span(c, name, None, {}):
            yield c
            finished = True
            c._read_events(True)
    finally:
        if not finished:
            c._read_events(False)
        _local.call = None
        if _enabled:
            _write([sp.label() for sp in c.spans])
        for fn in c.publish:
            fn(c)


def span(name: str, device=None, **ids):
    """A span of the current call (`device`: the torch.device its work
    runs on, for CUDA events on a card); outside a call, nothing."""
    c = getattr(_local, "call", None)
    if c is None:
        return _NOTHING
    return Span(c, name, device, ids)


def count(name: str, n: int = 1) -> None:
    """Adds n to the current call's counter `name`."""
    c = getattr(_local, "call", None)
    if c is not None:
        c.counts[name] = c.counts.get(name, 0) + n


def _wait(fn, nbytes: int):
    """Runs fn, a wait of the host for a device, as the child span
    `<parent>.fetch` of the current call, counted in `syncs` with its
    bytes in `sync_bytes`."""
    c = getattr(_local, "call", None)
    if c is None:
        return fn()
    c.counts["syncs"] += 1
    c.counts["sync_bytes"] += nbytes
    with Span(c, c.stack[-1].name + ".fetch", None, {"bytes": nbytes}):
        return fn()


def fetch(t: torch.Tensor) -> np.ndarray:
    """t's values on the host as a numpy array (waits for t's device)."""
    return _wait(lambda: t.cpu().numpy(), t.numel() * t.element_size())


def item(t: torch.Tensor):
    """The value of the one-element tensor t as a Python number."""
    return _wait(t.item, t.element_size())


def nonzero(t: torch.Tensor) -> tuple:
    """t.nonzero(as_tuple=True): the host waits for the count."""
    return _wait(lambda: t.nonzero(as_tuple=True), 8)


def upload(a, dev: torch.device) -> torch.Tensor:
    """a (a numpy array or a CPU tensor) on `dev`, copied from pageable
    memory: the copy waits for the device's stream."""
    t = torch.from_numpy(np.ascontiguousarray(a)) \
        if isinstance(a, np.ndarray) else a
    return _wait(lambda: t.to(dev), t.numel() * t.element_size())


def synchronize(dev: torch.device) -> None:
    """Waits until a card has finished its work; nothing on the CPU."""
    if dev.type == "cuda":
        _wait(lambda: torch.cuda.synchronize(dev), 0)
