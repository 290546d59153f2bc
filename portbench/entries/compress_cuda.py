"""Entry `compress_cuda`: `zlibng_tpu_torch.compress_cuda` on the cell's
first card. A request is a slice of the data; the answer is one stream in
the configuration's framing, judged as compression. After each call the
program's stage clocks (`ops/deflate.py:stage_seconds`) go into the
call's record; K1 and K2 launches come from `ops/probe.py:launches` and
`ops/parse.py:launches`."""
from __future__ import annotations

from portbench import geometry, reference

JUDGED_AS = "compress"


def prepare(data: bytes, codec: dict, traffic: dict):
    """What the benchmark makes once for this entry: nothing."""
    return None


def argument(prepared, data: bytes, req):
    off, size = req
    return data[off:off + size]


def bytes_in(prepared, req) -> int:
    return req[1]


def shape(codec: dict, size: int):
    """What decides the kernels a request of `size` bytes runs: its lane
    groups. Set-up warms one request of each."""
    return tuple(geometry.stage1_groups(size, codec["level"],
                                        codec["strategy"]))


def expected_launches(codec: dict, reqs: list) -> dict:
    """K1 and K2 launches, (B, N[, deep]) each, that the frozen geometry
    implies for `reqs`."""
    k1, k2 = [], []
    for _, size in reqs:
        k1 += geometry.k1_launches(size, codec["level"], codec["strategy"])
        k2 += geometry.k2_launches(size, codec["level"], codec["strategy"])
    return dict(k1=k1, k2=k2)


class Program:
    """The port, on `devices[0]`."""

    def __init__(self, devices: list, codec: dict):
        from zlibng_tpu_torch import compress_cuda
        from zlibng_tpu_torch.ops import deflate, parse, probe
        self._compress, self._deflate = compress_cuda, deflate
        self._probe, self._parse = probe, parse
        self.device, self.codec = devices[0], codec

    def __call__(self, arg: bytes) -> bytes:
        c = self.codec
        return self._compress(arg, c["level"], wbits=c["wbits"],
                              strategy=c["strategy"], device=self.device)

    def readings(self) -> dict:
        return {"stage": dict(self._deflate.stage_seconds)}

    def launches(self) -> dict:
        return {"k1": self._probe.launches, "k2": self._parse.launches}


class Control:
    """The reference in the program's place, at less effort than the
    configuration states (`reference.control_compress`)."""

    def __init__(self, devices: list, codec: dict):
        self.codec = codec

    def __call__(self, arg: bytes) -> bytes:
        return reference.control_compress(arg, self.codec)

    def readings(self) -> dict:
        return {}

    def launches(self) -> dict:
        return {}


def half(program, arg: bytes) -> bytes:
    """The fault `half`: only the first half of the request compressed."""
    return program(arg[: len(arg) // 2])
