"""compress_cuda (PyTorch port, device="cpu") against compress_tpu for
zlib, raw and gzip framing and window sizes 2^9..2^15, with and without a
preset dictionary: byte-identical streams that stdlib zlib decodes."""
import zlib

import pytest

from zlibng_tpu.ops.deflate_tpu import compress_tpu
from zlibng_tpu_torch import compress_cuda

from torch_corpus import pigz

N = 40000


@pytest.mark.parametrize("use_dict", [False, True])
@pytest.mark.parametrize("wbits", [9, 12, 15, -15, 31])
def test_wbits_and_dictionary_byte_identical(wbits, use_dict):
    src = pigz()
    data = src[100000: 100000 + N]
    zdict = src[60000: 100000] if use_dict else None
    want = compress_tpu(data, 6, wbits, dictionary=zdict)
    got = compress_cuda(data, 6, wbits, dictionary=zdict, device="cpu")
    assert got == want
    body, w = got, wbits
    if wbits > 15 and zdict:
        # zlib takes no dictionary for gzip streams: inflate the raw body
        body, w = got[10:-8], -15
    d = zlib.decompressobj(w, zdict=zdict) if zdict else zlib.decompressobj(w)
    assert d.decompress(body) + d.flush() == data
