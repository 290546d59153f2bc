"""The port's zng_-named surface (`zlibng_tpu_torch.zng`), `compat`, the
checksum combines (`crc32_combine_gen`, `crc32_combine_op`,
`adler32_partials`) and `utils.bitwriter`, against the JAX package's,
replaying test_zng_surface.py, test_compat.py and the combine cases of
test_checksums.py: the same calls on both packages give the same bytes,
values and errors, and zlib agrees."""
import gzip
import os
import zlib

import numpy as np
import pytest

from zlibng_tpu.checksum import adler32 as r_adler
from zlibng_tpu.checksum import crc32 as r_crc
from zlibng_tpu.utils.bitwriter import BitWriter as RefBitWriter
from zlibng_tpu_torch.checksum import adler32 as p_adler
from zlibng_tpu_torch.checksum import crc32 as p_crc
from zlibng_tpu_torch.utils.bitwriter import BitWriter

from test_torch_native import route
from test_torch_stream_api import PORT, REF, ROUTES, both, header_fields, \
    outcome

DATA = (b"hello, hello! " * 400) + bytes(range(256)) * 20

EXPORTS = """zlibng_version zng_deflateInit zng_deflate zng_deflateEnd
zng_inflateInit zng_inflate zng_inflateEnd zng_deflateInit2
zng_deflateSetDictionary zng_deflateGetDictionary zng_deflateCopy
zng_deflateReset zng_deflateParams zng_deflateTune zng_deflateBound
zng_deflatePending zng_deflatePrime zng_deflateSetHeader zng_inflateInit2
zng_inflateSetDictionary zng_inflateGetDictionary zng_inflateSync
zng_inflateCopy zng_inflateReset zng_inflateReset2 zng_inflatePrime
zng_inflateMark zng_inflateGetHeader zng_inflateBackInit zng_inflateBack
zng_inflateBackEnd zng_zlibCompileFlags zng_compress zng_compress2
zng_compressBound zng_uncompress zng_uncompress2 zng_gzopen zng_gzdopen
zng_gzbuffer zng_gzsetparams zng_gzread zng_gzfread zng_gzwrite zng_gzfwrite
zng_gzprintf zng_gzputs zng_gzgets zng_gzputc zng_gzgetc zng_gzungetc
zng_gzflush zng_gzseek zng_gzrewind zng_gztell zng_gzoffset zng_gzeof
zng_gzdirect zng_gzclose zng_gzclose_r zng_gzclose_w zng_gzerror
zng_gzclearerr zng_adler32 zng_adler32_z zng_adler32_combine zng_crc32
zng_crc32_z zng_crc32_combine zng_crc32_combine_gen zng_crc32_combine_op
zng_deflateSetParams zng_deflateGetParams zng_zError zng_inflateSyncPoint
zng_get_crc_table zng_inflateUndermine zng_inflateValidate
zng_inflateCodesUsed zng_inflateResetKeep zng_deflateResetKeep
zng_gzopen_w zng_gzvprintf""".split()


@pytest.mark.parametrize("module", ["zng", "compat"])
def test_every_export_present(module):
    for m in (PORT, REF):
        mod = getattr(m, module)
        assert not [n for n in EXPORTS if not callable(getattr(mod, n, None))]
    assert sorted(PORT.zng.__all__) == sorted(REF.zng.__all__)


def _deflate_family(m):
    z = m.zng
    s = z.zng_deflateInit2(level=6)
    z.zng_deflateParams(s, 9, 0)
    z.zng_deflateTune(s, 32, 258, 258, 128)     # zlib-ng L9 tunes 4096
    bound = z.zng_deflateBound(s, len(DATA))
    out = z.zng_deflate(s, DATA[:1000], m.api.Z_NO_FLUSH)
    pending = z.zng_deflatePending(s)
    s2 = z.zng_deflateCopy(s)
    out += z.zng_deflate(s, DATA[1000:], m.api.Z_FINISH)
    z.zng_deflateEnd(s)
    assert zlib.decompress(out) == DATA
    out2 = z.zng_deflate(s2, DATA[1000:], m.api.Z_FINISH)
    assert zlib.decompress(out[: len(out) - len(out2)] + out2) == DATA
    z.zng_deflateReset(s2)
    z.zng_deflateResetKeep(s2)
    z.zng_deflateSetParams(s2, {"level": 1, "reproducible": True})
    params = z.zng_deflateGetParams(s2)
    assert params["level"] == 1
    d0 = z.zng_deflateInit()
    one = z.zng_deflate(d0, DATA, m.api.Z_FINISH)
    return (bound, out, pending, out2, params, one,
            z.zng_deflateBound(None, 1000), z.Z_DEFLATE_LEVEL,
            z.zng_deflate_param.Z_DEFLATE_REPRODUCIBLE)


def test_deflate_family_roundtrip():
    both(_deflate_family)


def _deflate_dict_prime(m):
    z = m.zng
    dic = b"hello, hello! "
    s = z.zng_deflateInit2(level=6, windowBits=-15)
    z.zng_deflateSetDictionary(s, dic)
    got_dict = z.zng_deflateGetDictionary(s)
    out = z.zng_deflate(s, DATA[:500], m.api.Z_FINISH)
    d = zlib.decompressobj(-15, zdict=dic)
    assert d.decompress(out) == DATA[:500]
    s = z.zng_deflateInit2(level=1, windowBits=-15)
    z.zng_deflatePrime(s, 3, 0)
    raw = z.zng_deflate(s, b"abc", m.api.Z_FINISH)
    return got_dict, out, raw


def test_deflate_dictionary_and_prime():
    both(_deflate_dict_prime)


def _inflate_family(m, route_name):
    z = m.zng
    comp = zlib.compress(DATA, 6)
    with route(route_name):
        s = z.zng_inflateInit2(15)
        z.zng_inflateValidate(s, True)
        out = z.zng_inflate(s, comp[:50])
        mark = z.zng_inflateMark(s)
        s2 = z.zng_inflateCopy(s)
        out += z.zng_inflate(s, comp[50:], m.api.Z_FINISH)
        used = z.zng_inflateCodesUsed(s)
        out2 = z.zng_inflate(s2, comp[50:], m.api.Z_FINISH)
        z.zng_inflateReset(s2)
        z.zng_inflateReset2(s2, 31)
        z.zng_inflateResetKeep(s2)
        z.zng_inflateEnd(s2)
        under = outcome(lambda: z.zng_inflateUndermine(s, True))
        i0 = z.zng_inflateInit()
        again = z.zng_inflate(i0, comp, m.api.Z_FINISH)
    assert out == again == DATA and used > 0
    assert out[: len(out) - len(out2)] + out2 == DATA
    return out, mark, used, out2, s2.wbits, under, z.zng_inflateMark(s)


@pytest.mark.parametrize("route_name", ROUTES)
def test_inflate_family(route_name):
    both(_inflate_family, route_name)


def _inflate_dict_sync_prime(m, route_name):
    z = m.zng
    dic = b"hello, hello! "
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 8, 0, zdict=dic)
    comp = c.compress(DATA[:500]) + c.flush()
    with route(route_name):
        s = z.zng_inflateInit2(15)
        need = outcome(lambda: z.zng_inflate(s, comp, m.api.Z_FINISH))
        s = z.zng_inflateInit2(15)
        z.zng_inflate(s, comp[:3])
        z.zng_inflateSetDictionary(s, dic)
        got = z.zng_inflate(s, comp[3:], m.api.Z_FINISH)
        window = z.zng_inflateGetDictionary(s)[-len(dic):]
        c = zlib.compressobj(6)
        part = c.compress(DATA) + c.flush(zlib.Z_FULL_FLUSH)
        s = z.zng_inflateInit2(15)
        s.decompress(part[:100])
        point = z.zng_inflateSyncPoint(s)
        synced = z.zng_inflateSync(s)
        s = z.zng_inflateInit2(-15)
        z.zng_inflatePrime(s, 0, 0)
    assert got == DATA[:500]
    return need, got, window, point, synced


@pytest.mark.parametrize("route_name", ROUTES)
def test_inflate_dictionary_sync_prime(route_name):
    both(_inflate_dict_sync_prime, route_name)


def _back_and_header(m, route_name):
    z = m.zng
    raw = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = raw.compress(DATA) + raw.flush()
    chunks = [comp[i:i + 999] for i in range(0, len(comp), 999)]
    with route(route_name):
        state = z.zng_inflateBackInit()
        got = bytearray()
        z.zng_inflateBack(state, lambda: chunks.pop(0) if chunks else b"",
                          got.extend)
        z.zng_inflateBackEnd(state)
        twice = outcome(lambda: z.zng_inflateBack(state, lambda: b"",
                                                  got.extend))
        hdr = m.H.GzipHeader(name=b"f.txt", comment=b"c", extra=b"xx",
                             time=1234, os=3)
        s = z.zng_deflateInit2(6, windowBits=31)
        z.zng_deflateSetHeader(s, hdr)
        gz = z.zng_deflate(s, DATA, m.api.Z_FINISH)
        i = z.zng_inflateInit2(31)
        out = z.zng_inflate(i, gz, m.api.Z_FINISH)
    assert bytes(got) == DATA and out == DATA
    return twice, gz, header_fields(z.zng_inflateGetHeader(i))


@pytest.mark.parametrize("route_name", ROUTES)
def test_inflate_back_and_header(route_name):
    both(_back_and_header, route_name)


def _oneshot_checksums(m):
    z = m.zng
    c = z.zng_compress(DATA)
    c2 = z.zng_compress2(DATA, 1)
    out, used = z.zng_uncompress2(c2 + b"trailing")
    assert z.zng_uncompress(c) == DATA and out == DATA and used == len(c2)
    a, b = DATA[:700], DATA[700:]
    c1, cc2 = z.zng_crc32(0, a), z.zng_crc32(0, b)
    op = z.zng_crc32_combine_gen(len(b))
    vals = (z.zng_adler32_combine(z.zng_adler32(1, a), z.zng_adler32(1, b),
                                  len(b)),
            z.zng_adler32_z(1, DATA), z.zng_adler32(0xDEAD),
            z.zng_crc32(0xDEAD), z.zng_crc32_combine(c1, cc2, len(b)),
            z.zng_crc32_combine_op(c1, cc2, op), z.zng_crc32_z(0, DATA))
    assert vals == (zlib.adler32(DATA), zlib.adler32(DATA), 1, 0,
                    zlib.crc32(DATA), zlib.crc32(DATA), zlib.crc32(DATA))
    return (c, c2, vals, op.tolist(), z.zng_compressBound(1000),
            z.zng_get_crc_table().tolist(),
            [z.zng_zError(e) for e in range(-7, 3)],
            z.zng_zlibCompileFlags(), z.zlibng_version(),
            outcome(lambda: z.zng_uncompress(c[:-1])))


def test_oneshot_and_checksums():
    got = both(_oneshot_checksums)
    assert "zlib-ng" in got[8] and got[6][4] == "data error"


def _gz_layer(m, tmp):
    z = m.zng
    p = os.path.join(tmp, f"{m.name}.gz")
    f = z.zng_gzopen(p, "wb", level=6)
    z.zng_gzbuffer(f, 1 << 16)
    w = [z.zng_gzwrite(f, DATA[:100]), z.zng_gzfwrite(f, DATA[100:200], 10,
                                                      10),
         z.zng_gzputc(f, 0x41), z.zng_gzputs(f, b"line\n"),
         z.zng_gzprintf(f, "%d-%s\n", 7, "x"),
         z.zng_gzvprintf(f, "%d\n", (9,))]
    z.zng_gzsetparams(f, 9, 0)
    z.zng_gzwrite(f, DATA[200:])
    z.zng_gzflush(f, m.api.Z_SYNC_FLUSH)
    assert not z.zng_gzeof(f)
    z.zng_gzclose_w(f)
    with open(p, "rb") as fh:
        written = fh.read()
    expect = DATA[:200] + b"A" + b"line\n" + b"7-x\n" + b"9\n" + DATA[200:]
    assert gzip.decompress(written) == expect
    f = z.zng_gzopen(p, "rb")
    r = [z.zng_gzread(f, 100), z.zng_gzfread(f, 10, 10)]
    ch = z.zng_gzgetc(f)
    r += [ch, z.zng_gzungetc(ch, f), z.zng_gzgetc(f), z.zng_gzgets(f),
          z.zng_gztell(f), z.zng_gzseek(f, 201, os.SEEK_SET),
          z.zng_gzread(f, 5), z.zng_gzoffset(f) >= 0, z.zng_gzdirect(f)]
    z.zng_gzrewind(f)
    r += [z.zng_gzread(f, 200), len(z.zng_gzread(f, 10 ** 9)),
          z.zng_gzeof(f), z.zng_gzerror(f)]
    z.zng_gzclearerr(f)
    z.zng_gzclose_r(f)
    fd = os.open(p, os.O_RDONLY)
    f = z.zng_gzdopen(fd, "rb")
    r.append(z.zng_gzread(f, 3))
    z.zng_gzclose(f)
    q = os.path.join(tmp, f"{m.name}-w.gz")
    f = z.zng_gzopen_w(q, "wb")
    z.zng_gzwrite(f, b"abc")
    z.zng_gzclose(f)
    with open(q, "rb") as fh:
        assert gzip.decompress(fh.read()) == b"abc"
    return w, written, r


def test_gz_layer(tmp_path):
    w, written, r = both(_gz_layer, str(tmp_path))
    assert r[6] == 206 and r[8] == b"line\n" and r[14] == ("", 0)


# ---------------------------------------------------------------------------
# compat
# ---------------------------------------------------------------------------
CDATA = b"compat surface exercise data " * 1000


def _compat(m, route_name):
    c = m.compat
    one = c.compress2(CDATA, 6)
    assert zlib.decompress(one) == CDATA and c.compress2(CDATA, 6) == one
    with route(route_name):
        res = [one, c.uncompress(one), c.uncompress2(one), c.compress(CDATA),
               c.uncompress(c.compress2(CDATA, 1)[2:-4], wbits=-15)]
        strm = c.deflate_init(level=4)
        out = strm.compress(CDATA[:5000])
        c.deflate_set_params(strm, level=9)
        out += strm.compress(CDATA[5000:], 4)
        inf = c.inflate_init()
        res += [out, c.deflate_get_params(strm),
                inf.decompress(out, finish=True)]
    res += [c.adler32_z(CDATA), c.crc32_z(CDATA), c.adler32(CDATA, 7),
            c.crc32_combine_op(1, 2, c.crc32_combine_gen(10)),
            len(c.get_crc_table()), c.zlibng_version(), c.z_error(-3),
            c.z_error(2), c.z_error(99), c.zlib_compile_flags(),
            c.deflate_bound(100_000), c.deflate_bound(100, -15),
            (c.Z_DEFLATE_LEVEL, c.Z_DEFLATE_STRATEGY,
             c.Z_DEFLATE_REPRODUCIBLE)]
    assert res[1] == res[7] == CDATA and res[6]["level"] == 9
    return res


@pytest.mark.parametrize("route_name", ROUTES)
def test_compat_names(route_name):
    res = both(_compat, route_name)
    assert "2.2.2" in res[13] and res[14] == "data error"


def _compat_inflate_back(m):
    comp = zlib.compress(CDATA, 9)[2:-4]
    chunks = [comp[i:i + 777] for i in range(0, len(comp), 777)]
    it = iter(chunks + [b""])
    out = bytearray()
    m.inflate.inflate_back(lambda: next(it), out.extend)
    dictionary = b"compat surface exercise data "
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 8, 0, dictionary)
    it2 = iter([co.compress(CDATA) + co.flush(), b""])
    out2 = bytearray()
    m.inflate.inflate_back(lambda: next(it2), out2.extend, window=dictionary)
    assert bytes(out) == bytes(out2) == CDATA
    return bytes(out)


def test_compat_inflate_back():
    both(_compat_inflate_back)


# ---------------------------------------------------------------------------
# checksum combines and partials
# ---------------------------------------------------------------------------
RNG_DATA = np.random.default_rng(42).integers(0, 256, 100_000,
                                              np.uint8).tobytes()


@pytest.mark.parametrize("len2", [0, 1, 100, 2048, 5552, 99_999])
def test_crc32_combine_gen_op(len2):
    a, b = RNG_DATA[:len(RNG_DATA) - len2], RNG_DATA[len(RNG_DATA) - len2:]
    op = p_crc.crc32_combine_gen(len2)
    ref_op = r_crc.crc32_combine_gen(len2)
    assert op.dtype == ref_op.dtype and np.array_equal(op, ref_op)
    got = p_crc.crc32_combine_op(zlib.crc32(a), zlib.crc32(b), op)
    assert got == r_crc.crc32_combine_op(zlib.crc32(a), zlib.crc32(b),
                                         ref_op) == zlib.crc32(RNG_DATA)
    assert p_crc.crc32_combine(zlib.crc32(a), zlib.crc32(b), len2) == got


@pytest.mark.parametrize("shape", [(8, 4096), (3, 5553), (1, 1), (5, 0)])
def test_adler32_partials_tree_merge(shape):
    data = np.random.default_rng(7).integers(0, 256, shape, np.uint8)
    parts, m = p_adler.adler32_partials(data)
    ref_parts, ref_m = r_adler.adler32_partials(data)
    assert parts.dtype == ref_parts.dtype and np.array_equal(parts, ref_parts)
    assert m == ref_m == shape[1]
    acc = int(parts[0])
    for p in parts[1:]:
        acc = p_adler.adler32_combine(acc, int(p), m)
    assert acc == zlib.adler32(data.tobytes())


# ---------------------------------------------------------------------------
# utils.bitwriter
# ---------------------------------------------------------------------------
def _bits(cls):
    bw = cls()
    trail = []
    for value, n in ((1, 1), (1, 2), (0x1FF, 9), (0, 3), (0xABCDE, 20)):
        bw.write(value, n)
        trail.append(bw.bitpos)
    partial = bw.getvalue()
    try:
        bw.write_bytes(b"x")
    except AssertionError as e:
        trail.append(("AssertionError", str(e)))
    bw.align()
    bw.write_bytes(b"\x00\x00\xff\xff")
    bw.write(0b101, 3)
    return trail, partial, bw.getvalue(), bytes(bw.buf), bw.hold, bw.nbits


def test_bitwriter_matches_reference():
    got = _bits(BitWriter)
    assert got == _bits(RefBitWriter)
    assert got[0][-1] == ("AssertionError",
                          "write_bytes requires byte alignment")
    # a stored block built by hand decodes with zlib
    bw = BitWriter()
    bw.write(1, 1)
    bw.write(0, 2)
    bw.align()
    bw.write_bytes((5).to_bytes(2, "little") + (0xFFFA).to_bytes(2, "little")
                   + b"hello")
    assert zlib.decompress(bw.getvalue(), -15) == b"hello"
