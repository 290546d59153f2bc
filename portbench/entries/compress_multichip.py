"""Entry `compress_multichip`: `zlibng_tpu_torch.compress_multichip` with
one shard per card of the cell, in one process: pigz's layout (`pigz -z
-b 128 -p 4`), lanes of the configuration's `lane_block`, each with the
32 KiB before it as history, one DEFLATE block per lane, the blocks
stitched and the shards' adler32s combined on the host. A request is a
slice of the data; the answer is one zlib stream, judged as compression.
After each call the program's spans and counters
(`ops/deflate.py:stage_seconds`, cleared before the call, so a program
whose sharded path opens no trace root reports none) go into the call's
record; K1 and K2 launches come from `ops/probe.py:launches` and
`ops/parse.py:launches`."""
from __future__ import annotations

from portbench import geometry, pigz_plain

JUDGED_AS = "compress"
# pigz's -p 4: four compress threads, one shard on each card of the cell
SHARDS = 4


def prepare(data: bytes, codec: dict, traffic: dict):
    """What the benchmark makes once for this entry: nothing."""
    return None


def argument(prepared, data: bytes, req):
    off, size = req
    return data[off:off + size]


def bytes_in(prepared, req) -> int:
    return req[1]


def expected_launches(codec: dict, reqs: list) -> dict:
    """K1 and K2 launches, (B, N[, deep]) each, for `reqs`: one of each
    per shard, over its lanes (the lane count padded to the shards) of
    LANE_HIST + lane_block positions."""
    lb = codec["lane_block"]
    N = geometry.LANE_HIST + lb
    deep = geometry.CHAIN[max(1, min(9, codec["level"]))] \
        > geometry.DENSE_PROBES
    k1, k2 = [], []
    for _, size in reqs:
        lanes = max(1, -(-size // lb))
        per_shard = -(-lanes // SHARDS)
        k1 += [(per_shard, N, deep)] * SHARDS
        k2 += [(per_shard, N)] * SHARDS
    return dict(k1=k1, k2=k2)


class Program:
    """The port, one shard on each of `devices`."""

    def __init__(self, devices: list, codec: dict):
        from zlibng_tpu_torch import compress_multichip
        from zlibng_tpu_torch.ops import deflate, parse, probe
        if len(devices) != SHARDS:
            raise ValueError(f"compress_multichip entry: {SHARDS} devices, "
                             f"got {len(devices)}")
        self._compress, self._deflate = compress_multichip, deflate
        self._probe, self._parse = probe, parse
        self.devices, self.codec = list(devices), codec

    def __call__(self, arg: bytes) -> bytes:
        c = self.codec
        self._deflate.stage_seconds.clear()
        return self._compress(arg, devices=self.devices, level=c["level"],
                              lane_block=c["lane_block"])

    def readings(self) -> dict:
        return {"stage": dict(self._deflate.stage_seconds)}

    def launches(self) -> dict:
        return {"k1": self._probe.launches, "k2": self._parse.launches}


class Control:
    """The plain pigz-layout reference (`portbench/pigz_plain.py`) in the
    program's place at level 1, less effort than the configuration
    states."""

    def __init__(self, devices: list, codec: dict):
        self.codec = codec

    def __call__(self, arg: bytes) -> bytes:
        return pigz_plain.compress(arg, level=1,
                                   block=self.codec["lane_block"])

    def readings(self) -> dict:
        return {}

    def launches(self) -> dict:
        return {}


def half(program, arg: bytes) -> bytes:
    """The fault `half`: only the first half of the request compressed."""
    return program(arg[: len(arg) // 2])
