"""The yardstick's frozen copies against the originals they were copied
from: the corpus and the indexed archive of `chip_smoke.py`, and the lane
geometry of `zlibng_tpu_torch/ops/deflate.py` against the shapes the
program's stage 1 hands K1 and K2 on the CPU."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from portbench import archive, geometry  # noqa: E402
from portbench.generators import mixed_kinds  # noqa: E402


@pytest.fixture(scope="module")
def corpora():
    return {s: mixed_kinds.make(s) for s in (chip_smoke.SEED, 3141592653)}


@pytest.mark.parametrize("seed", [chip_smoke.SEED, 3141592653])
def test_corpus_equals_chip_smoke(corpora, seed):
    want, _ = chip_smoke.corpus(seed)
    assert corpora[seed] == want and len(want) == 8_912_896


@pytest.mark.parametrize("seed", [chip_smoke.SEED, 3141592653])
def test_indexed_archive_equals_chip_smoke(corpora, seed):
    data = corpora[seed]
    blob, idx = chip_smoke.indexed_blob(data)
    got, comp, out = archive.indexed(data, 6, chip_smoke.DECODE_SEGMENT)
    assert got == blob
    assert comp == idx.comp_offsets and out == idx.out_offsets
    assert len(comp) == 10          # 9 segments and the end


@pytest.mark.parametrize("n,level,strategy", [
    (1500, 6, 0), (70_000, 6, 0), (200_000, 1, 0), (300_000, 6, 4),
    (140_000, 6, 2), (2_300_000, 1, 0)])
def test_geometry_matches_the_programs_stage1(monkeypatch, corpora, n,
                                              level, strategy):
    """Every K1 and K2 call of a CPU compress_cuda call, with its (B, N),
    is the one the frozen geometry predicts."""
    from zlibng_tpu_torch import compress_cuda
    from zlibng_tpu_torch.ops import deflate, lz77
    seen = {"k1": [], "k2": []}
    probe_best, parse = lz77.probe_best, deflate.parse_select_encode

    def k1(w2_s, *a, **k):
        B, N, W = w2_s.shape
        assert W == geometry.PROBE_WORDS
        deep = k["chain"] > a[3]          # chain beyond the dense probes
        seen["k1"].append((B, N, deep))
        return probe_best(w2_s, *a, **k)

    def k2(step, bounds):
        seen["k2"].append(tuple(step.shape))
        return parse(step, bounds)

    monkeypatch.setattr(lz77, "probe_best", k1)
    monkeypatch.setattr(deflate, "parse_select_encode", k2)
    data = corpora[chip_smoke.SEED][:n]
    out = compress_cuda(data, level, strategy=strategy, device="cpu")
    assert len(out) > 0
    assert seen["k1"] == geometry.k1_launches(n, level, strategy)
    assert seen["k2"] == geometry.k2_launches(n, level, strategy)


def test_quick_rule_and_byte_bounds():
    assert geometry.quick(1, 0) and geometry.quick(6, 4)
    assert not geometry.quick(6, 0) and not geometry.quick(1, 1)
    # the frozen byte counts against chip_smoke.py's
    assert geometry.k1_bytes(8, 294_912, False) == chip_smoke._k1_bytes(
        8, 294_912, 4, False)
    assert geometry.k1_bytes(3, 100, True) == chip_smoke._k1_bytes(
        3, 100, 4, True)
    assert geometry.k2_bytes(8, 294_912) == 5 * 8 * 294_912 + 64
    assert geometry.lane_block(8_912_896) == 1 << 18
    assert len(geometry.stage1_groups(8_912_896, 6)) == 5
