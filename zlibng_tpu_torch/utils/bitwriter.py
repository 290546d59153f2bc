"""LSB-first bit writer (the host analog of trees_emit.h send_bits), for
assembling headers and building test streams by hand. A copy of
`zlibng_tpu/utils/bitwriter.py`."""
from __future__ import annotations


class BitWriter:
    __slots__ = ("buf", "hold", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.hold = 0    # pending bits, LSB-first
        self.nbits = 0

    def write(self, value: int, nbits: int) -> None:
        self.hold |= (value & ((1 << nbits) - 1)) << self.nbits
        self.nbits += nbits
        while self.nbits >= 8:
            self.buf.append(self.hold & 0xFF)
            self.hold >>= 8
            self.nbits -= 8

    def align(self) -> None:
        """Pad with zero bits to the next byte boundary (bi_windup analog)."""
        if self.nbits:
            self.buf.append(self.hold & 0xFF)
            self.hold = 0
            self.nbits = 0

    def write_bytes(self, data: bytes) -> None:
        if self.nbits:  # the reference's assert, kept under -O
            raise AssertionError("write_bytes requires byte alignment")
        self.buf += data

    @property
    def bitpos(self) -> int:
        return len(self.buf) * 8 + self.nbits

    def getvalue(self) -> bytes:
        """Flushed bytes; pads a final partial byte with zeros."""
        out = bytes(self.buf)
        if self.nbits:
            out += bytes([self.hold & 0xFF])
        return out
