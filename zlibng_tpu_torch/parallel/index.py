"""Block-boundary index for parallel decode.

Counterpart of `zlibng_tpu/parallel/index.py`. Z_FULL_FLUSH emits a
byte-aligned empty stored block (00 00 FF FF) and resets history, so the
stream after a marker decodes on its own (what pigz emits and inflateSync
scans for, zlib-ng inflate.c:1290-1366). An index is either recorded at
compress time (exact) or rebuilt by scanning for markers (speculative,
verified by decoding).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..errors import DataError
from ..stream.inflate_serial import RawInflater

SYNC_MARKER = b"\x00\x00\xff\xff"


@dataclass
class StreamIndex:
    """Offsets of independently-decodable segments of a raw deflate stream.

    comp_offsets[i]..comp_offsets[i+1] decode to
    out_offsets[i]..out_offsets[i+1] with no history dependency.
    """
    comp_offsets: list = field(default_factory=list)   # byte offsets
    out_offsets: list = field(default_factory=list)    # uncompressed offsets
    total_out: int = 0

    def to_json(self) -> str:
        return json.dumps({"comp": self.comp_offsets, "out": self.out_offsets,
                           "total_out": self.total_out})

    @classmethod
    def from_json(cls, s: str) -> "StreamIndex":
        d = json.loads(s)
        return cls(d["comp"], d["out"], d["total_out"])


def decompress_indexed(blob: bytes, index: StreamIndex) -> bytes:
    """Decode every indexed segment on its own with the serial decoder;
    order is restored by the index."""
    n = len(index.comp_offsets) - 1
    out = bytearray(index.total_out)
    for i in range(n):
        c0, c1 = index.comp_offsets[i], index.comp_offsets[i + 1]
        o0, o1 = index.out_offsets[i], index.out_offsets[i + 1]
        inf = RawInflater()
        inf.feed(blob[c0:c1])
        inf.run(finish=(i == n - 1))
        got = inf.output()
        # non-final segments end with the sync marker's empty stored block;
        # the output length must match the index
        if len(got) != o1 - o0:
            got = got[: o1 - o0]
            if len(got) != o1 - o0:
                raise DataError("index/stream mismatch")
        out[o0:o1] = got
    return bytes(out)


def decompress_indexed_cuda(blob: bytes, index: StreamIndex,
                            device="cuda") -> bytes:
    """Indexed parallel decode on `device` (the card unless device="cpu"):
    all segments advance in lockstep waves through ops/inflate's batched
    phase A dispatches (one dispatch per lane bucket decodes one block of
    every segment), then one phase B for all of them."""
    from ..ops.inflate import decompress_segments_cuda

    n = len(index.comp_offsets) - 1
    outs = decompress_segments_cuda(blob, index.comp_offsets[:-1],
                                    device=device)
    parts = []
    for i in range(n):
        o0, o1 = index.out_offsets[i], index.out_offsets[i + 1]
        got = outs[i][: o1 - o0]
        if len(got) != o1 - o0:
            raise DataError("index/stream mismatch")
        parts.append(got)
    return b"".join(parts)


def find_sync_candidates(blob: bytes, start: int = 0) -> list:
    """Every 00 00 FF FF occurrence is a candidate full-flush point
    (inflateSync semantics: false positives possible, verify by decoding);
    returns the offsets just past each marker."""
    out = []
    i = blob.find(SYNC_MARKER, start)
    while i >= 0:
        out.append(i + 4)       # decoding resumes after the marker
        i = blob.find(SYNC_MARKER, i + 1)
    return out


def build_index_by_scan(blob: bytes) -> StreamIndex:
    """Rebuild an index for an un-indexed raw stream written with
    full-flush markers: decode each candidate segment and keep the ones
    that verify (speculate, then validate)."""
    idx = StreamIndex()
    cands = [0] + find_sync_candidates(blob)
    out_pos = 0
    for i, c in enumerate(cands):
        end = cands[i + 1] if i + 1 < len(cands) else len(blob)
        inf = RawInflater()
        inf.feed(blob[c:end])
        try:
            inf.run(finish=(end == len(blob)))
            got = len(inf.output())
        except DataError:
            continue            # false-positive marker inside data
        idx.comp_offsets.append(c)
        idx.out_offsets.append(out_pos)
        out_pos += got
    idx.comp_offsets.append(len(blob))
    idx.out_offsets.append(out_pos)
    idx.total_out = out_pos
    return idx
