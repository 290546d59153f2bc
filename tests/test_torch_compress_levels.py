"""compress_cuda (PyTorch port, device="cpu") against compress_tpu at
levels 2, 6 and 9: byte-identical streams that stdlib zlib decodes."""
import zlib

import pytest

from zlibng_tpu.ops.deflate_tpu import compress_tpu
from zlibng_tpu_torch import compress_cuda

from torch_corpus import sample

N = 40000


@pytest.mark.parametrize("level", [2, 6, 9])
@pytest.mark.parametrize("corpus", ["pigz", "text", "a4", "runs"])
def test_levels_byte_identical(level, corpus):
    data = sample(corpus, N, seed=level)
    want = compress_tpu(data, level)
    got = compress_cuda(data, level, device="cpu")
    assert got == want
    assert zlib.decompress(got) == data


def test_tracing_reports_dispatches_and_block_bits():
    """With tracing on, every stage's span is traced with its lane group
    and every coded block's bits are audited against its stored bound
    (none may exceed it)."""
    from zlibng_tpu_torch import trace
    from zlibng_tpu_torch.ops import deflate as tdef
    data = sample("text", N)
    lines = []
    before = dict(tdef.audit)
    try:
        trace.enable(True, sink=lines.append)
        got = compress_cuda(data, 6, device="cpu")
    finally:
        trace.enable(False)
    assert got == compress_tpu(data, 6)
    assert any(ln.startswith("[zlibng_tpu_torch] stage1#")
               and " group=0 " in ln for ln in lines)
    assert any(ln.startswith("[zlibng_tpu_torch] stage2#")
               and " group=0 " in ln for ln in lines)
    assert any(ln.startswith("[zlibng_tpu_torch] stage2.partition#")
               for ln in lines)
    blocks = [ln for ln in lines if "bits_sent=" in ln]
    assert blocks and not any("OVERRUN" in ln for ln in blocks)
    assert tdef.audit["groups_checked"] - before["groups_checked"] \
        == len(blocks)
    assert tdef.audit["bit_overruns"] == before["bit_overruns"]
