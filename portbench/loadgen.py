"""The one traffic generator: reads a mix's parameters from
`portbench/traffic/<name>.json` and makes its requests from `--seed` and
the configuration.

Parameters of a mix, each naming a file of its own where it names a kind:
- `entry`: the program's entry the requests go to,
  `portbench/entries/<entry>.py` (what the entry is called with, what the
  benchmark makes for it once, how its answers are judged);
- `requests`: `{"kind": <kind>, ...}`, the sizes of one cycle of
  requests, `portbench/requests/<kind>.py`; each cycle sends them in a
  seeded order, each at a seeded offset of the data, so every seed gives
  the same work;
- `loop`: how requests are sent over the window,
  `portbench/loops/<loop>.py`;
- `profile_calls`: how many requests the traced run profiles after the
  window;
- anything else an entry reads (`segment` for an indexed archive).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

from .generators.mixed_kinds import rand64

HERE = Path(__file__).resolve().parent
# splitmix64 streams of the request order, the offsets and the warm-up
_ORDER, _OFFSET, _WARM = 1 << 16, 1 << 17, 1 << 18


def module(kind: str, name: str):
    """`portbench/<kind>/<name>.py`, loaded by its path."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Plan:
    """The requests of one mix on one configuration's data at one seed.
    A request is (offset, size) into the data; the entry turns it into
    what the program is called with, and the reference compares the
    answer with the request's bytes."""

    def __init__(self, traffic: dict, config: dict, data: bytes, seed: int):
        self.traffic, self.codec = traffic, config["codec"]
        self.data, self.seed = data, seed
        self.entry = module("entries", traffic["entry"])
        self.loop = module("loops", traffic["loop"])
        spec = traffic["requests"]
        self.sizes = module("requests", spec["kind"]).sizes(spec, len(data))
        if max(self.sizes) > len(data):
            raise ValueError("traffic: requests longer than the data")
        self.profile_calls = int(traffic.get("profile_calls", 1))
        self.prepared = self.entry.prepare(data, self.codec, traffic)

    def requests(self):
        """Endless: each cycle a seeded permutation of the sizes."""
        k = len(self.sizes)
        for cycle in range(1 << 20):
            order = np.argsort(rand64(self.seed, _ORDER + cycle, k),
                               kind="stable")
            offs = rand64(self.seed, _OFFSET + cycle, k)
            for j in order.tolist():
                size = self.sizes[j]
                span = np.uint64(len(self.data) - size + 1)
                yield int(offs[j] % span), size

    def warmup(self) -> list:
        """One request for each distinct shape the requests take (the
        entry's `shape`, else the size)."""
        shape = getattr(self.entry, "shape", lambda codec, size: size)
        sizes = sorted(self.sizes, reverse=True)
        offs = rand64(self.seed, _WARM, len(sizes))
        seen, out = set(), []
        for size, r in zip(sizes, offs.tolist()):
            key = shape(self.codec, size)
            if key not in seen:
                seen.add(key)
                out.append((r % (len(self.data) - size + 1), size))
        return out

    def argument(self, req):
        return self.entry.argument(self.prepared, self.data, req)

    def bytes_in(self, req) -> int:
        return self.entry.bytes_in(self.prepared, req)

    def expected(self, req):
        off, size = req
        return memoryview(self.data)[off:off + size]

    def describe(self) -> str:
        """One line on the mix, for the run's standard error."""
        s = self.sizes
        return (f"{self.traffic['entry']}, {self.traffic['loop']} loop: "
                f"{len(s)} size(s) {min(s)}..{max(s)} B")
