"""compress_cuda (PyTorch port, device="cpu") against compress_tpu on an
input of several lanes (the stitch across lanes, a padded lane group),
split into several lane groups (the group pipeline), and at stage-2 seams
(final block stored, coded after stored): byte-identical streams that
stdlib zlib decodes."""
import zlib

import pytest

from zlibng_tpu.ops.deflate_tpu import UNIT, compress_tpu
from zlibng_tpu_torch import compress_cuda
from zlibng_tpu_torch.ops import deflate as tdef

from torch_corpus import pigz, sample


@pytest.fixture(scope="module")
def multilane():
    data = pigz()[:300000]                       # 3 lanes of 128 KiB
    return data, compress_tpu(data, 6)


def test_multilane_byte_identical(multilane):
    data, want = multilane
    got = compress_cuda(data, 6, device="cpu")
    assert got == want
    assert zlib.decompress(got) == data


def test_lane_groups_do_not_change_bytes(multilane, monkeypatch):
    """Groups of one lane (three groups through the pipeline) give the
    bytes of the reference's single group."""
    data, want = multilane
    monkeypatch.setattr(tdef, "GROUP_BYTES", 1 << 17)
    assert compress_cuda(data, 6, device="cpu") == want


@pytest.mark.parametrize("case", ["final_stored", "coded_after_stored"])
def test_stage2_seams_byte_identical(case):
    rnd = sample("a256", UNIT + 100, seed=1)
    if case == "final_stored":
        data = sample("text", 3 * UNIT) + rnd
    else:
        data = rnd[:UNIT] + sample("text", 4 * UNIT)
    want = compress_tpu(data, 6)
    got = compress_cuda(data, 6, device="cpu")
    assert got == want
    assert zlib.decompress(got) == data
