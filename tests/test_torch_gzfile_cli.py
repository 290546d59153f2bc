"""The port's gzFile layer (`zlibng_tpu_torch/stream/gzfile.py`) and CLIs
(`cli/minigzip.py`, `cli/minideflate.py`) against the JAX package's,
replaying test_gzfile_cli.py: both packages write the same files and read
the same bytes back, Python's gzip module reads what they write, and the
port's CLIs, run as `python -m zlibng_tpu_torch.cli...` in a subprocess,
write what the reference's write in-process. `minigzip -t` compresses
with compress_cuda: with device="cpu" its .gz equals the reference's `-t`
output (compress_tpu on the JAX CPU backend) at L6 and L1; without a card
it raises."""
import gzip
import io
import os
import subprocess
import sys
import zlib
from types import SimpleNamespace

import pytest
import torch

from test_torch_native import route
from test_torch_stream_api import PORT, REF, ROUTES, both, outcome
from torch_corpus import pigz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = b"gzfile layer test data with some repetition repetition\n" * 500


def _path(tmp, m, name):
    return os.path.join(tmp, f"{m.name}-{name}")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_read(m, tmp, mode):
    p = _path(tmp, m, "t.gz")
    with m.gzfile.GzFile(p, mode) as g:
        n = g.write(DATA)
        pos = g.tell()
    with m.gzfile.GzFile(p, "rb") as g:
        back = g.read()
        state = (g.eof(), g.direct(), g.tell(), g.error())
    assert back == DATA and gzip.decompress(_read(p)) == DATA
    return _read(p), n, pos, state


@pytest.mark.parametrize("route_name", ROUTES)
@pytest.mark.parametrize("mode", ["wb", "wb9", "wb1"])
def test_write_read_roundtrip(tmp_path, route_name, mode):
    with route(route_name):
        both(_write_read, str(tmp_path), mode)


def test_reads_gzip_module_files(tmp_path):
    p = str(tmp_path / "u.gz")
    with gzip.open(p, "wb") as f:
        f.write(DATA)

    def read(m):
        with m.gzfile.GzFile(p, "rb") as g:
            return g.read(), g.offset()

    assert both(read)[0] == DATA


def _getc_gets(m, tmp):
    p = _path(tmp, m, "t.gz")
    with m.gzfile.GzFile(p, "wb") as g:
        g.puts("line one\nline two\n")
        g.putc(ord("x"))
        g.printf("%d-%s\n", 5, "y")
    g = m.gzfile.GzFile(p, "rb")
    res = [g.gets(), g.getc()]
    res += [g.ungetc(res[-1]), g.tell(), g.gets(), g.getc(), g.gets(4),
            g.gets(), g.getc(), g.eof()]
    g.close()
    return _read(p), res


def test_getc_gets_ungetc(tmp_path):
    _, res = both(_getc_gets, str(tmp_path))
    assert res[:3] == [b"line one\n", ord("l"), ord("l")]
    assert res[4:] == [b"line two\n", ord("x"), b"5-y", b"\n", -1, True]


def _seek(m, tmp):
    p = _path(tmp, m, "t.gz")
    with m.gzfile.GzFile(p, "wb") as g:
        g.write(DATA)
    g = m.gzfile.GzFile(p, "rb", bufsize=4096)
    res = [g.seek(100), g.tell(), g.read(10), g.seek(50), g.read(10),
           g.seek(20, os.SEEK_CUR), g.read(5), g.seek(10 ** 6), g.eof()]
    g.rewind()
    res += [g.tell(), g.read(7)]
    g.close()
    w = m.gzfile.GzFile(_path(tmp, m, "w.gz"), "wb")
    w.write(b"abc")
    res += [w.seek(10), outcome(lambda: w.seek(2)),
            outcome(lambda: w.rewind()), outcome(lambda: w.read(1))]
    w.write(b"xyz")
    w.close()
    res.append(_read(_path(tmp, m, "w.gz")))
    return res


def test_seek_tell(tmp_path):
    res = both(_seek, str(tmp_path))
    assert res[2] == DATA[100:110] and res[4] == DATA[50:60]
    assert gzip.decompress(res[-1]) == b"abc" + bytes(7) + b"xyz"


def _transparent_multimember(m, tmp):
    plain = _path(tmp, m, "plain.txt")
    with open(plain, "wb") as f:
        f.write(b"not gzip data")
    g = m.gzfile.GzFile(plain, "rb")
    res = [g.read(), g.direct()]
    g.close()
    mm = _path(tmp, m, "mm.gz")
    with open(mm, "wb") as f:
        f.write(gzip.compress(b"first|", mtime=1)
                + gzip.compress(b"second", mtime=2) + bytes(16))
    with m.gzfile.GzFile(mm, "rb") as g:
        res.append(g.read())
    bad = _path(tmp, m, "bad.gz")
    blob = bytearray(gzip.compress(DATA, mtime=1))
    blob[-8] ^= 1
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    g = m.gzfile.GzFile(bad, "rb")
    res += [outcome(lambda: g.read()), g.error()]
    g.clearerr()
    res.append(g.error())
    g.close()
    return res


@pytest.mark.parametrize("route_name", ROUTES)
def test_transparent_and_multimember_read(tmp_path, route_name):
    with route(route_name):
        res = both(_transparent_multimember, str(tmp_path))
    assert res[:3] == [b"not gzip data", True, b"first|second"]
    assert res[3][2] == res[4][0] == "incorrect data check"


def _flush_params_append(m, tmp):
    p = _path(tmp, m, "t.gz")
    g = m.gzfile.GzFile(p, "wb")
    g.write(b"before flush ")
    g.flush()
    g.write(b"after flush")
    g.close()
    q = _path(tmp, m, "p.gz")
    g = m.gzfile.GzFile(q, "wb1")
    g.write(DATA[:1000])
    g.set_params(9)
    g.write(DATA[1000:])
    g.close()
    a = _path(tmp, m, "a.gz")
    with m.gzfile.gzopen(a, "wb") as f:
        f.write(b"first part\n")
    with m.gzfile.gzopen(a, "ab") as f:
        f.write(b"second part\n")
    with m.gzfile.gzopen(a, "rb") as f:
        joined = f.read()
    fd = os.open(a, os.O_RDONLY)
    with m.gzfile.gzdopen(fd, "rb") as f:
        via_fd = f.read(5)
    new = _path(tmp, m, "new.gz")
    with m.gzfile.gzopen(new, "a") as f:
        f.write(b"hello")
    return _read(p), _read(q), _read(a), joined, via_fd, _read(new)


def test_flush_setparams_append(tmp_path):
    p, q, a, joined, via_fd, new = both(_flush_params_append, str(tmp_path))
    assert gzip.decompress(p) == b"before flush after flush"
    assert gzip.decompress(q) == DATA
    assert joined == gzip.decompress(a) == b"first part\nsecond part\n"
    assert via_fd == b"first" and gzip.decompress(new) == b"hello"


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------
def _port_cli(tool: str, *args, stdin: bytes | None = None):
    return subprocess.run(
        [sys.executable, "-m", f"zlibng_tpu_torch.cli.{tool}", *args],
        cwd=ROOT, input=stdin, capture_output=True, timeout=300)


def test_cli_minigzip(tmp_path):
    """minigzip -k -9 in a subprocess writes the reference's .gz (its
    main() in-process on a copy), and the port's -d reads it back."""
    src, ref_src = tmp_path / "file.txt", tmp_path / "ref.txt"
    src.write_bytes(DATA)
    ref_src.write_bytes(DATA)
    r = _port_cli("minigzip", "-k", "-9", str(src))
    assert r.returncode == 0, r.stderr
    assert REF.minigzip.main(["-k", "-9", str(ref_src)]) == 0
    gz = _read(str(src) + ".gz")
    assert gz == _read(str(ref_src) + ".gz")
    assert gzip.decompress(gz) == DATA and src.exists()
    os.unlink(src)
    assert PORT.minigzip.main(["-d", str(src) + ".gz"]) == 0
    assert src.read_bytes() == DATA and not os.path.exists(str(src) + ".gz")


@pytest.mark.parametrize("flags", [["-6"], ["-1", "-h"], ["-T"], ["-F"]])
def test_minigzip_in_process_matches_reference(tmp_path, flags):
    def run(m):
        path = _path(str(tmp_path), m, "in.bin")
        with open(path, "wb") as f:
            f.write(pigz()[:20000])
        assert m.minigzip.main(flags + [path]) == 0
        assert not os.path.exists(path)
        gz = _read(path + ".gz")
        assert m.minigzip.main(["-d", "-k", path + ".gz"]) == 0
        return gz, _read(path)

    gz, back = both(run)
    assert back == pigz()[:20000] == gzip.decompress(gz)


def _stdio(monkeypatch, tool_main, args, data: bytes) -> bytes:
    """tool_main(args) with stdin holding data; its stdout bytes."""
    out = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(data)))
    monkeypatch.setattr(sys, "stdout", SimpleNamespace(buffer=out))
    assert tool_main(args) == 0
    return out.getvalue()


@pytest.mark.parametrize("args", [["-c", "-R", "-3"], ["-c", "-d"]])
def test_minigzip_stdio_matches_reference(monkeypatch, args):
    data = gzip.compress(DATA, mtime=3) if "-d" in args else DATA
    got = both(lambda m: _stdio(monkeypatch, m.minigzip.main, args, data))
    assert got == DATA or gzip.decompress(got) == DATA


MINIDEFLATE = {"raw L4": (["-w", "-15", "-4"], -15),
               "gzip, memLevel 1, Z_FIXED": (["-w", "31", "-m", "1", "-s",
                                              "4"], 31),
               "zlib L9": (["-9"], 15)}


@pytest.mark.parametrize("name", list(MINIDEFLATE))
def test_minideflate_matches_reference(monkeypatch, name):
    args, wbits = MINIDEFLATE[name]
    comp = both(lambda m: _stdio(monkeypatch, m.minideflate.main, args, DATA))
    assert zlib.decompress(comp, wbits) == DATA
    back = both(lambda m: _stdio(monkeypatch, m.minideflate.main,
                                 ["-d", "-w", str(wbits)], comp))
    assert back == DATA


def test_cli_minideflate_subprocess(tmp_path, monkeypatch):
    src = tmp_path / "file.txt"
    src.write_bytes(DATA)
    r = _port_cli("minideflate", "-w", "-15", "-4", str(src))
    assert r.returncode == 0, r.stderr
    assert r.stdout == REF.api.Deflate(level=4, wbits=-15).compress(
        DATA, REF.api.Z_FINISH)
    back = SimpleNamespace(buffer=io.BytesIO())
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(
        buffer=io.BytesIO(r.stdout)))
    monkeypatch.setattr(sys, "stdout", back)
    assert PORT.minideflate.main(["-d", "-w", "-15"]) == 0
    assert back.buffer.getvalue() == DATA


@pytest.mark.parametrize("level", [6, 1])
def test_minigzip_t_on_cpu_equals_reference(tmp_path, level):
    """compress_file(..., use_tpu=True, device="cpu"): the port's -t
    output equals the reference's -t (compress_tpu, JAX on the CPU) on
    64 KiB, and decodes through the port's minigzip -d."""
    data = pigz()[:65536]
    port_src, ref_src = tmp_path / "port.bin", tmp_path / "ref.bin"
    port_src.write_bytes(data)
    ref_src.write_bytes(data)
    PORT.minigzip.compress_file(str(port_src), level, 0, True, False, True,
                                device="cpu")
    REF.minigzip.compress_file(str(ref_src), level, 0, True, False, True)
    gz = _read(str(port_src) + ".gz")
    assert gz == _read(str(ref_src) + ".gz")
    assert gzip.decompress(gz) == data
    os.unlink(port_src)
    assert PORT.minigzip.main(["-d", str(port_src) + ".gz"]) == 0
    assert port_src.read_bytes() == data


def test_minigzip_t_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: -t runs on it")
    src = tmp_path / "file.txt"
    src.write_bytes(DATA)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PORT.minigzip.main(["-t", str(src)])
    assert not os.path.exists(str(src) + ".gz")
    assert src.read_bytes() == DATA
