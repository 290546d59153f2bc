"""Opt-in tracing (the ZLIB_DEBUG Trace/Tracev analog, zutil.h:100-120).

Enabled by the ZLIBNG_TPU_TRACE environment variable (any non-empty value
other than "0") or programmatically via enable(). Traces go to stderr by
default; enable(sink=fn) redirects them.

The compression path traces each stage dispatch (stage, lane group, host
ms) and, per coded block, the bits sent against the block's stored bound
(the trees.c:693 `compressed_len == bits_sent` invariant).
"""
from __future__ import annotations

import os
import sys
import time

_enabled = os.environ.get("ZLIBNG_TPU_TRACE", "") not in ("", "0")
_sink = None


def enabled() -> bool:
    return _enabled


def enable(on: bool = True, sink=None) -> None:
    """Turn tracing on/off at runtime (the z_verbose analog); optional
    sink(line: str) replaces the stderr writer."""
    global _enabled, _sink
    _enabled = on
    _sink = sink


def trace(fmt: str, *args) -> None:
    if not _enabled:
        return
    line = ("[zlibng_tpu_torch] " + (fmt % args if args else fmt))
    if _sink is not None:
        _sink(line)
    else:
        print(line, file=sys.stderr, flush=True)


class span:
    """Context manager timing one traced operation (host ms)."""

    def __init__(self, fmt: str, *args):
        self.label = fmt % args if args else fmt

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _enabled:
            trace("%s: %.2f ms", self.label,
                  1e3 * (time.perf_counter() - self.t0))
        return False
