"""Entry `decompress_indexed_cuda`:
`zlibng_tpu_torch.parallel.index.decompress_indexed_cuda` on the cell's
first card, decoding an indexed archive of the whole data that the
benchmark makes in set-up with the standard library's zlib
(`archive.indexed`: the configuration's level, a full flush every
`segment` bytes of the mix). The answer is judged as a decode: byte for
byte against the data. After each call the program's phase split
(`ops/inflate.py:decode_stats`) goes into the call's record."""
from __future__ import annotations

from portbench import archive, reference

JUDGED_AS = "decode"


def prepare(data: bytes, codec: dict, traffic: dict):
    """The archive and its index: (blob, comp_offsets, out_offsets)."""
    return archive.indexed(data, codec["level"], traffic["segment"])


def argument(prepared, data: bytes, req):
    return prepared


def bytes_in(prepared, req) -> int:
    return len(prepared[0])


class Program:
    """The port, on `devices[0]`."""

    def __init__(self, devices: list, codec: dict):
        from zlibng_tpu_torch.ops import inflate
        from zlibng_tpu_torch.parallel import index
        self._index, self._inflate = index, inflate
        self.device = devices[0]

    def __call__(self, arg) -> bytes:
        blob, comp, out = arg
        idx = self._index.StreamIndex(list(comp), list(out), out[-1])
        return self._index.decompress_indexed_cuda(blob, idx,
                                                   device=self.device)

    def readings(self) -> dict:
        return {"decode": {k: v for k, v in
                           self._inflate.decode_stats.items()
                           if isinstance(v, (int, float))}}

    def launches(self) -> dict:
        return {}


class Control:
    """The reference in the program's place, giving up the archive's
    last segment (`reference.control_decode`)."""

    def __init__(self, devices: list, codec: dict):
        pass

    def __call__(self, arg) -> bytes:
        return reference.control_decode(*arg)

    def readings(self) -> dict:
        return {}

    def launches(self) -> dict:
        return {}


def half(program, arg) -> bytes:
    """The fault `half`: the later half of the segments never written."""
    out = program(arg)
    offs = arg[2]
    end = offs[max(1, (len(offs) - 1) // 2)]
    return out[:end] + bytes(len(out) - end)
