"""The plain reference that decides `correct`, and the controls that show
the comparison can fail.

It imports nothing of the program and takes nothing the program made but
the answers it judges. A compressed stream is judged twice:
- read back with the standard library's zlib (an independent decoder): it
  has to decode, in the configuration's framing, to exactly the request's
  bytes, end where its trailer ends (the trailer's adler32, or CRC-32 and
  ISIZE, checked by zlib) and carry nothing after it (`wrong_answers`,
  exact, limit 0);
- its size against zlib's own stream of the same bytes at the
  configuration's level, strategy, window and memLevel: `size_excess_pct`
  is the largest excess over the window's answers, in %, held to the
  configuration's limit, so that a program that compresses with less
  effort than the level states fails.
A decode is judged by comparing every byte with the data the benchmark
made (`wrong_answers`, exact).

A control is this reference put in the program's place with less than the
configuration states: for compression zlib at a lower level than the
configuration's (level 1 below levels 2-9, level 0, stored blocks, below
level 1; levels 4 and 5 do not separate, their streams being within
the port's own excess over level 6); for a decode the archive's last
segment given up.
"""
from __future__ import annotations

import zlib


def stream_ok(data, stream: bytes, wbits: int) -> bool:
    """Whether `stream` decodes in framing `wbits` to exactly `data`."""
    d = zlib.decompressobj(wbits)
    try:
        out = d.decompress(stream)
    except zlib.error:
        return False
    return d.eof and not d.unused_data and out == data


def zlib_stream(data, level: int, wbits: int, strategy: int = 0,
                mem_level: int = 8) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, wbits, mem_level, strategy)
    return co.compress(data) + co.flush()


def judge(kind: str, codec: dict, limits: dict, answers: list,
          n_failed: int) -> dict:
    """The numbers compared, each with its limit. `answers` holds
    (request, expected bytes, answer) for every request that returned;
    `n_failed` counts the requests that raised."""
    checks = {"wrong_answers": {"value": 0, "limit": 0},
              "failed_calls": {"value": n_failed, "limit": 0}}
    if kind == "decode":
        checks["wrong_answers"]["value"] = sum(
            bytes(e) != bytes(o) for _, e, o in answers)
        return checks
    wbits = codec["wbits"]
    checks["wrong_answers"]["value"] = sum(
        not stream_ok(e, o, wbits) for _, e, o in answers)
    own: dict = {}
    excess = None
    for req, e, o in answers:
        if req not in own:
            own[req] = len(zlib_stream(e, codec["level"], wbits,
                                       codec["strategy"],
                                       codec.get("mem_level", 8)))
        x = 100.0 * (len(o) / own[req] - 1.0)
        excess = x if excess is None else max(excess, x)
    if excess is not None:
        checks["size_excess_pct"] = {"value": excess,
                                     "limit": limits["size_excess_pct"]}
    return checks


def control_compress(data, codec: dict) -> bytes:
    """zlib's stream of `data` in the configuration's framing at level 1,
    or at level 0 where the configuration states level 1."""
    level = 1 if codec["level"] > 1 else 0
    return zlib_stream(data, level, codec["wbits"], codec["strategy"])


def control_decode(blob: bytes, comp_offsets: list, out_offsets: list
                   ) -> bytes:
    """Every segment of an indexed archive but the last, decoded by
    zlib."""
    parts = []
    for i in range(len(comp_offsets) - 2):
        d = zlib.decompressobj(-15)
        parts.append(d.decompress(blob[comp_offsets[i]:comp_offsets[i + 1]]))
    return b"".join(parts)
