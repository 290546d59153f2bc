"""gzFile-style buffered file I/O: a copy of `zlibng_tpu/stream/gzfile.py`.

The zlib-ng gzlib.c / gzread.c.in / gzwrite.c surface as one Python file
object: gzopen/gzdopen (via GzFile), gzread/gzwrite/gzgets/gzputs/gzputc/
gzgetc/gzungetc/gzprintf, gzseek/gztell/gzrewind/gzoffset, gzflush,
gzbuffer, gzsetparams, gzeof/gzdirect/gzerror/gzclearerr, multi-member
reads and transparent (non-gzip) reads. It writes through Deflate and
reads through Inflate (`stream/api.py`), on the host.
"""
from __future__ import annotations

import io
import os

from ..errors import DataError, StreamError
from ..format.constants import GZIP_MAGIC
from .api import Deflate, Inflate, Z_FINISH, Z_NO_FLUSH, Z_SYNC_FLUSH


class GzFile:
    """gzFile analog. mode: 'rb' or 'wb' (+ digit = level, as gzopen)."""

    def __init__(self, path=None, mode: str = "rb", fileobj=None,
                 level: int = 6, strategy: int = 0, bufsize: int = 1 << 17):
        for ch in mode:
            if ch.isdigit():
                level = int(ch)
        self.mode = "w" if ("w" in mode or "a" in mode) else "r"
        if fileobj is not None:
            self.f = fileobj
        else:
            # gzopen(path, "a") appends a new gzip member to the existing
            # file (gzlib.c:95-180); multi-member read joins them.
            self.f = open(path, ("a" if "a" in mode else self.mode) + "b")
        self.bufsize = bufsize
        self.level = level
        self.strategy = strategy
        self._err = None
        self._eof = False
        self._direct = False       # transparent (non-gzip) read
        self._started = False
        self._pos = 0              # uncompressed offset (gztell)
        self._ungot = bytearray()
        if self.mode == "w":
            self._def = Deflate(level=level, wbits=31, strategy=strategy)
            self._wbuf = bytearray()
        else:
            self._inf = Inflate(wbits=31)
            self._rbuf = bytearray()   # decoded, not yet read
            self._raw_done = False

    # -- write side ------------------------------------------------------
    def write(self, data: bytes) -> int:
        if self.mode != "w":
            raise StreamError("file not open for writing")
        self._wbuf += data
        if len(self._wbuf) >= self.bufsize:
            self.f.write(self._def.compress(bytes(self._wbuf), Z_NO_FLUSH))
            self._wbuf.clear()
        self._pos += len(data)
        return len(data)

    def putc(self, c: int) -> int:
        self.write(bytes([c]))
        return c

    def puts(self, s) -> int:
        b = s.encode() if isinstance(s, str) else bytes(s)
        return self.write(b)

    def printf(self, fmt: str, *args) -> int:
        return self.write((fmt % args).encode())

    def flush(self, mode: int = Z_SYNC_FLUSH) -> None:
        """gzflush."""
        if self.mode != "w":
            return
        self.f.write(self._def.compress(bytes(self._wbuf), mode))
        self._wbuf.clear()
        self.f.flush()

    def set_params(self, level: int, strategy: int = 0) -> None:
        """gzsetparams: flush current data, change parameters."""
        self.f.write(self._def.compress(bytes(self._wbuf), Z_SYNC_FLUSH))
        self._wbuf.clear()
        self._def.params(level, strategy)
        self.level = level
        self.strategy = strategy

    # -- read side -------------------------------------------------------
    def _fill(self, want: int) -> None:
        """Decode until we have `want` bytes buffered or input ends."""
        if self.mode != "r":
            raise StreamError("file not open for reading")
        if not self._started:
            head = self.f.read(2)
            self._started = True
            if head != GZIP_MAGIC:
                self._direct = True     # transparent mode (gzdirect)
                self._rbuf += head
            else:
                self._pending_in = head
                self._inf_feed(head)
        while len(self._rbuf) < want:
            chunk = self.f.read(self.bufsize)
            if self._direct:
                if not chunk:
                    self._eof = True
                    return
                self._rbuf += chunk
                continue
            if not chunk:
                # final drain
                try:
                    out = self._inf.decompress(b"", finish=True)
                except DataError as e:
                    self._err = e
                    raise
                self._rbuf += out
                self._eof = True
                return
            self._inf_feed(chunk)

    def _inf_feed(self, chunk: bytes) -> None:
        try:
            out = self._inf.decompress(chunk)
        except DataError as e:
            self._err = e
            raise
        self._rbuf += out
        # multi-member: if a member finished and input remains, start anew
        while self._inf.eof:
            rest = getattr(self._inf, "unused_data", b"")
            if not rest or not any(rest):
                break
            self._inf = Inflate(wbits=31)
            out = self._inf.decompress(rest)
            self._rbuf += out

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            chunks = []
            while True:
                c = self.read(self.bufsize)
                if not c:
                    break
                chunks.append(c)
            return b"".join(chunks)
        out = bytearray()
        if self._ungot:
            take = min(n, len(self._ungot))
            out += self._ungot[:take]
            del self._ungot[:take]
        if len(out) < n and not (self._eof and not self._rbuf):
            self._fill(n - len(out))
            take = min(n - len(out), len(self._rbuf))
            out += self._rbuf[:take]
            del self._rbuf[:take]
        self._pos += len(out)
        return bytes(out)

    def getc(self) -> int:
        b = self.read(1)
        return b[0] if b else -1

    def ungetc(self, c: int) -> int:
        self._ungot.insert(0, c)
        self._pos -= 1
        return c

    def gets(self, maxlen: int = 65536) -> bytes:
        """gzgets: read up to and including a newline."""
        out = bytearray()
        while len(out) < maxlen - 1:
            b = self.read(1)
            if not b:
                break
            out += b
            if b == b"\n":
                break
        return bytes(out)

    # -- position --------------------------------------------------------
    def tell(self) -> int:
        """gztell: uncompressed offset."""
        return self._pos

    def offset(self) -> int:
        """gzoffset: compressed-file offset."""
        return self.f.tell()

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        """gzseek: write side emits zeros; read side skips (re-reading from
        the start for backward seeks, like gzread.c)."""
        if whence == os.SEEK_CUR:
            offset += self._pos
        if self.mode == "w":
            if offset < self._pos:
                raise StreamError("cannot seek backwards while writing")
            self.write(b"\x00" * (offset - self._pos))
            return self._pos
        if offset < self._pos:
            self.rewind()
        while self._pos < offset:
            chunk = self.read(min(self.bufsize, offset - self._pos))
            if not chunk:
                break
        return self._pos

    def rewind(self) -> None:
        if self.mode != "r":
            raise StreamError("rewind on write stream")
        self.f.seek(0)
        self.__init__(fileobj=self.f, mode="rb", level=self.level,
                      bufsize=self.bufsize)

    # -- status ----------------------------------------------------------
    def eof(self) -> bool:
        return self._eof and not self._rbuf and not self._ungot

    def direct(self) -> bool:
        """gzdirect: reading non-gzip data transparently?"""
        return self._direct

    def error(self):
        """gzerror: (message, errno-ish)."""
        return (str(self._err), -3) if self._err else ("", 0)

    def clearerr(self) -> None:
        self._err = None

    def buffer(self, size: int) -> None:
        """gzbuffer."""
        self.bufsize = size

    def close(self) -> None:
        if self.mode == "w":
            self.f.write(self._def.compress(bytes(self._wbuf), Z_FINISH))
            self._wbuf.clear()
        self.f.close()

    close_r = close  # gzclose_r / gzclose_w aliases
    close_w = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def gzopen(path, mode: str = "rb", **kw) -> GzFile:
    return GzFile(path, mode, **kw)


def gzdopen(fd: int, mode: str = "rb", **kw) -> GzFile:
    fm = "a" if "a" in mode else ("w" if "w" in mode else "r")
    return GzFile(fileobj=os.fdopen(fd, fm + "b"), mode=mode, **kw)
