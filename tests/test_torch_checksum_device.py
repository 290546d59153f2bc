"""The port's device checksums (`ops/checksum.py`, device="cpu") against
the JAX package's `adler32_jax`/`crc32_jax` and stdlib zlib, at lengths
around the 1024-byte chunk, with and without a seed; the carried combine
and GF(2) helpers against the reference's. Exact ints throughout."""
import zlib

import numpy as np
import pytest

import torch

from zlibng_tpu.checksum import adler32 as ref_adler
from zlibng_tpu.checksum import crc32 as ref_crc
from zlibng_tpu.ops import checksum_jax as ref_ck
from zlibng_tpu_torch.checksum import adler32 as t_adler
from zlibng_tpu_torch.checksum import crc32 as t_crc
from zlibng_tpu_torch.ops import checksum as tck

LENGTHS = [0, 1, 1023, 1024, 1025, 100000]


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_adler32_matches_reference_and_zlib(n, seed):
    data = _bytes(n, seed)
    for value in (1, 0x1234ABCD):
        got = tck.adler32_cuda(data, value, device="cpu")
        assert got == zlib.adler32(data, value)
        assert got == ref_ck.adler32_jax(data, value)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_crc32_matches_reference_and_zlib(n, seed):
    data = _bytes(n, seed)
    for value in (0, 0xDEADBEEF):
        got = tck.crc32_cuda(data, value, device="cpu")
        assert got == zlib.crc32(data, value)
        assert got == ref_ck.crc32_jax(data, value)


@pytest.mark.parametrize("kind", ["bytearray", "memoryview", "ndarray",
                                  "tensor"])
def test_checksums_take_every_buffer_kind(kind):
    data = _bytes(5000, 3)
    buf = {"bytearray": bytearray(data), "memoryview": memoryview(data),
           "ndarray": np.frombuffer(data, np.uint8),
           "tensor": torch.frombuffer(bytearray(data), dtype=torch.uint8)}[kind]
    assert tck.adler32_cuda(buf, device="cpu") == zlib.adler32(data)
    assert tck.crc32_cuda(buf, device="cpu") == zlib.crc32(data)


def test_chunk_table_extends_the_slicing_tables():
    """Rows 0-7 of the per-distance table are CRC_TABLES (slicing-by-8)."""
    from zlibng_tpu_torch.format.constants import CRC_TABLES
    tab = tck._chunk_table("cpu").view(tck.CHUNK, 256).numpy()
    np.testing.assert_array_equal(tab[:8], CRC_TABLES.astype(np.int64))
    assert tck.CHUNK == ref_ck.CHUNK


@pytest.mark.parametrize("n", [1, 7, 1024, 3000, 1 << 20])
def test_gf2_helpers_match_reference(n):
    np.testing.assert_array_equal(t_crc._shift_operator(n),
                                  ref_crc._shift_operator(n))
    op = ref_crc._shift_operator(n)
    for v in (0, 1, 0xFFFFFFFF, 0x1234567):
        assert t_crc._gf2_matrix_times(op, v) == \
            ref_crc._gf2_matrix_times(op, v)
    a, b = 0x89ABCDEF, 0x01234567
    assert t_crc.crc32_combine(a, b, n) == ref_crc.crc32_combine(a, b, n)
    assert t_adler.adler32_combine(a, b, n) == \
        ref_adler.adler32_combine(a, b, n)
    # the front padding comes off: crc(Z || A) -> crc(A)
    data, pad = _bytes(n % 5000 + 1, n), n % 4096
    assert tck._unpad_crc(zlib.crc32(bytes(pad) + data), pad, len(data)) \
        == zlib.crc32(data)


def test_combine_matrices_match_reference_rows():
    got = tck._combine_matrices(5, "cpu").numpy()
    want = np.asarray(ref_ck._combine_matrices(5))
    np.testing.assert_array_equal(got, want[:5].astype(np.int64))
