"""The PyTorch port's routing: a CUDA request never carries on on the CPU
(not even for the host encoder's inputs or the host decode engine),
wrappers route by tensor device, and the kernel build raises when it
cannot run. Tests marked `gpu` hold the CUDA kernels against their plain
versions and the card's output (compress, decode, checksums) against the
CPU's; without a card they skip. This file imports nothing of
JAX, so on a machine with a card and no JAX it runs as
`python -m pytest --noconftest -m gpu tests/test_torch_cuda_path.py`."""
import functools
import gzip
import inspect
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
import zlibng_tpu_torch
from zlibng_tpu_torch import _build, compress_cuda, decompress_cuda, trace
from zlibng_tpu_torch.errors import DataError, StreamError
from zlibng_tpu_torch.ops import (
    checksum, deflate, huffman, inflate, lz77, parse, probe,
)
from zlibng_tpu_torch.parallel import index, sharded

from torch_corpus import pigz, pigz_lanes, sample
from torch_mh_worker import run_ranks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def test_small_input_and_bad_wbits_raise():
    """Small inputs run (on the host encoder); bad wbits raise."""
    assert zlib.decompress(compress_cuda(b"x" * 1023, 6, device="cpu")) \
        == b"x" * 1023
    with pytest.raises(StreamError):
        compress_cuda(b"x" * 4096, 6, wbits=32, device="cpu")


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    assert inspect.signature(compress_cuda).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (probe.launches, parse.launches)
    with pytest.raises(RuntimeError, match="cuda"):
        zlibng_tpu_torch.compress_cuda(sample("text", 5000), 6)
    # the host encoder's inputs too: the device is checked first
    with pytest.raises(RuntimeError, match="cuda"):
        compress_cuda(sample("text", 5000), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        compress_cuda(b"x")
    assert (probe.launches, parse.launches) == before


def test_wrappers_route_by_device():
    before = (probe.launches, parse.launches)
    step = torch.ones((1, 64), dtype=torch.int32)
    bounds = torch.tensor([[0, 64]], dtype=torch.int32)
    assert bool(parse.parse_select(step, bounds).all())
    w = torch.zeros((1, 64, 4), dtype=torch.int32)
    s, _ = probe.probe_best(w, step, step, torch.zeros(1, dtype=torch.int32),
                            4, 16, 12)
    assert s.shape == (1, 64)
    assert (probe.launches, parse.launches) == before   # CPU: plain only
    with pytest.raises(ValueError):
        parse.parse_select(step.to("meta"), bounds.to("meta"))
    with pytest.raises(ValueError):
        probe.probe_best(w.to("meta"), step.to("meta"), step.to("meta"),
                         torch.zeros(1, dtype=torch.int32, device="meta"),
                         4, 16, 12)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_funcs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernel("probe")
    assert not (tmp_path / "build").exists() or \
        not list((tmp_path / "build").glob("*.so"))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 4])
def test_probe_kernel_matches_plain_on_card(card, W):
    rng = np.random.default_rng(W)
    lanes = torch.from_numpy(np.stack([
        np.frombuffer(sample("pigz", 9000), np.uint8),
        rng.integers(0, 8, 9000, dtype=np.uint8)])).to(card)
    pad = torch.cat([lanes, lanes.new_zeros((2, 16))], 1)
    w2_s, h_s, pos_s, _ = lz77.sorted_probe_rows(lz77._build_w4(pad), 9000)
    w2_s = w2_s[..., :W].contiguous()
    hv = torch.tensor([100, 0], dtype=torch.int32, device=card)
    for dense in (2, 4, 16, 24, 64):
        for max_dist in (512, 32768):
            args = (w2_s, h_s, pos_s, hv, dense, 16, 12, max_dist)
            n0 = probe.launches
            ks, kc = probe.probe_best(*args)
            assert probe.launches == n0 + 1
            ps, pc = probe._probe_best_plain(*args)
            assert torch.equal(ks, ps) and torch.equal(kc, pc)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense 64 (L9)", "chain 128",
                                  "chain 128, windowBits 9",
                                  "chain 1024, good 16"])
def test_probe_walk_matches_plain_on_card(card, case):
    """K1's walk, the dense and the deep probes in one launch, against its
    plain version (the dense sweep, then deep_probes) on chip_smoke.py's
    adversarial lanes, with every hist_valid_from and enc_end turn."""
    dense, chain, good, max_dist = chip_smoke.WALK_CASES[case]
    for turn in range(3):
        _, *ins = chip_smoke.walk_inputs(20000, 4096, turn, card)
        args = (*ins[:4], dense, lz77.GATE_DEPTH, good, max_dist, chain,
                4096, ins[4])
        n0 = probe.launches
        ks, kc = probe.probe_best(*args[:8], chain=chain, enc_start=4096,
                                  enc_end=ins[4])
        assert probe.launches == n0 + 1
        ps, pc = probe._probe_plain(*args)
        assert torch.equal(ks, ps) and torch.equal(kc, pc)
        # deep probes past a short halo read global memory
        ks, kc = probe._probe_best_cuda(*args, halo=chip_smoke.SHORT_HALO)
        assert torch.equal(ks, ps) and torch.equal(kc, pc)


def _parse_card_steps(n: int) -> dict:
    """Random literal/match steps and the arrays that defeat the segmented
    walk's speculation or test its step arithmetic, as (8, n) int32."""
    rng = np.random.default_rng(0)
    shape = (8, n)
    lit_match = np.where(rng.random(shape) < 0.3,
                         rng.integers(3, 259, shape), 1)
    rare = rng.random(shape) < 0.002
    neg = rng.integers(-2 ** 31, 0, shape, dtype=np.int64)
    return {
        "random": lit_match,
        "all-3": np.full(shape, 3),
        "all-258": np.full(shape, 258),
        "all-literal fused": (n - np.arange(n))[None].repeat(8, 0),
        "zeros": np.zeros(shape),
        "negative": np.where(rng.random(shape) < 0.5, neg, lit_match),
        "1<<26": np.where(rare, 1 << 26, lit_match),
        "2**31-1": np.where(rare, 2 ** 31 - 1, lit_match),
        "all 2**31-1": np.full(shape, 2 ** 31 - 1),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5000, 20000])
def test_parse_kernel_matches_plain_on_card(card, n):
    S = parse.SEG
    bounds = torch.tensor([[0, n], [10, n - 1000], [n - 1, n], [7, 7],
                           [100, n], [S + 953, 2 * S - 49], [0, 0],
                           [S - 1, S + 1]], dtype=torch.int32, device=card)
    steps = {k: torch.from_numpy(a.astype(np.int32)).to(card)
             for k, a in _parse_card_steps(n).items()}
    for kind, step in steps.items():
        for s in (step, parse.fused_steps(step)):
            # leave a freed block of sel's size full of 0xAB for it to reuse
            torch.full((8, n), 0xAB, dtype=torch.uint8, device=card)
            n0 = parse.launches
            got = parse.parse_select(s, bounds)
            assert parse.launches == n0 + 1
            assert got.dtype == torch.bool
            assert int(got.view(torch.uint8).max()) <= 1, kind
            assert torch.equal(got, parse._parse_select_plain(s, bounds)), \
                kind


@pytest.mark.gpu
@pytest.mark.parametrize("level", [6, 9])
def test_compress_on_card_matches_cpu(card, level):
    data = pigz()[:300000]
    n0 = (probe.launches, parse.launches, huffman.launches)
    got = compress_cuda(data, level, device=card)
    assert probe.launches > n0[0] and parse.launches > n0[1]
    assert huffman.launches > n0[2]          # tables and headers: the kernel
    assert got == compress_cuda(data, level, device="cpu")
    assert zlib.decompress(got) == data


@pytest.mark.gpu
@pytest.mark.parametrize("level,strategy", [(1, 0), (6, 4)])
def test_quick_path_on_card_matches_cpu(card, level, strategy):
    data = pigz()[:300000] + sample("a256", 20000)
    n0 = (probe.launches, parse.launches, huffman.launches)
    got = compress_cuda(data, level, strategy=strategy, device=card)
    assert probe.launches > n0[0] and parse.launches > n0[1]
    assert huffman.launches == n0[2]         # the quick path builds no tree
    assert got == compress_cuda(data, level, strategy=strategy, device="cpu")
    assert zlib.decompress(got) == data


def test_stage_clock_times_the_stream_of_its_card(monkeypatch):
    """A compress call's device spans record their events on the current
    stream of the call's card, and its root waits for that card, not the
    current device."""
    seen = {"record": [], "sync": []}

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self, stream=None):
            seen["record"].append(stream)

        def elapsed_time(self, other):
            return 250.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", device))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: seen["sync"].append(device))
    card1 = torch.device("cuda", 1)
    with trace.call("compress", deflate._publish):
        with trace.span("stage1", card1, group=0):
            pass
        with trace.span("stitch", group=0):
            pass
    assert seen["record"] == [("stream of", card1)] * 2
    assert seen["sync"] == [card1]
    assert deflate.stage_seconds["stage1"] == 0.25


@pytest.mark.gpu
def test_compress_on_explicit_card_index(card):
    """device="cuda:0" named explicitly: the stage clock times that card."""
    data = pigz()[:300000]
    got = compress_cuda(data, 6, device="cuda:0")
    assert got == compress_cuda(data, 6, device="cpu")
    assert deflate.stage_seconds["stage1"] > 0
    assert deflate.stage_seconds["stage2"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3])
def test_sharded_compress_on_card_matches_cpu(card, k):
    """k shards on the card: K1 and K2 launched, the CPU's bytes."""
    data = pigz()[:300000]
    n0 = (probe.launches, parse.launches)
    got = sharded.compress_multichip(data, ["cuda:0"] * k, lane_block=65536)
    assert probe.launches >= n0[0] + k and parse.launches >= n0[1] + k
    assert got == sharded.compress_multichip(data, ["cpu"] * k,
                                             lane_block=65536)
    assert zlib.decompress(got) == data


@pytest.mark.gpu
def test_sharded_decode_on_card_matches_cpu(card):
    data = pigz()[:300000]
    blob, idx = chip_smoke.indexed_blob(data, 65536)
    starts = idx.comp_offsets[:-1]
    n0, ok = parse.launches, inflate.stats["mesh_ok"]
    got = sharded.decompress_segments_multichip(blob, starts, ["cuda:0"] * 2)
    assert parse.launches > n0 and inflate.stats["mesh_ok"] == ok + 1
    assert got == inflate.decompress_segments_cuda(blob, starts, device="cpu")
    assert b"".join(got) == data


@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs 2 or more CUDA cards, found {n}")
    return [f"cuda:{i}" for i in range(n)]


@pytest.mark.gpu
def test_sharded_paths_across_cards(cards):
    """One shard per card in one process (and devices=None, every card):
    the CPU's bytes with as many shards, and the CPU's segments."""
    data = pigz()[:300000]
    n = len(cards)
    n0 = (probe.launches, parse.launches)
    got = sharded.compress_multichip(data, cards, lane_block=65536)
    assert probe.launches >= n0[0] + n and parse.launches >= n0[1] + n
    assert got == sharded.compress_multichip(data, lane_block=65536)
    assert got == sharded.compress_multichip(data, ["cpu"] * n,
                                             lane_block=65536)
    blob, idx = chip_smoke.indexed_blob(data, 32768)
    starts = idx.comp_offsets[:-1]
    ok = inflate.stats["mesh_ok"]
    assert sharded.decompress_segments_multichip(blob, starts, cards) \
        == inflate.decompress_segments_cuda(blob, starts, device="cpu")
    assert inflate.stats["mesh_ok"] == ok + 1


@pytest.mark.gpu
def test_pigz_layout_on_four_cards(cards, monkeypatch):
    """pigz's -b 128 with one shard per card on cuda:0-3: the CPU's bytes
    with four shards, and one stage 1 and one stage 2 span per shard, each
    on its own card with a device time."""
    if len(cards) < 4:
        pytest.skip(f"needs 4 CUDA cards, found {len(cards)}")
    data = pigz_lanes()
    seen = []
    publish = deflate._publish
    monkeypatch.setattr(deflate, "_publish",
                        lambda c: (seen.append(c), publish(c)))
    got = sharded.compress_multichip(data, cards[:4], level=6,
                                     lane_block=131072)
    (call,) = seen
    assert got == sharded.compress_multichip(data, ["cpu"] * 4, level=6,
                                             lane_block=131072)
    assert zlib.decompress(got) == data
    for name in ("sharded.stage1.shard", "sharded.stage2.shard"):
        spans = [sp for sp in call.spans if sp.name == name]
        assert [sp.ids["shard"] for sp in spans] == [0, 1, 2, 3]
        for sp in spans:
            assert sp.dev == torch.device("cuda", sp.ids["shard"])
            assert sp.device_s is not None and sp.device_s > 0


@pytest.mark.gpu
def test_multihost_nccl_across_cards(cards, tmp_path):
    """One NCCL rank per card (tests/torch_mh_worker.py): rank 0's stream
    equals the CPU's with as many shards; every rank decodes the
    segments on the sharded path."""
    data = pigz()[:200000] + sample("a256", 50000)
    n = len(cards)
    blob, decoded, moves = run_ranks(data, tmp_path, world=n, shards=1,
                                     lane_block=16384, backend="nccl",
                                     timeout=120)
    assert blob == sharded.compress_multichip(data, ["cpu"] * n,
                                              lane_block=16384)
    for dec, moved in zip(decoded, moves):
        assert dec == data
        assert moved["mesh_ok"] == 1 and moved["fallback"] == 0


@pytest.mark.gpu
def test_native_runtime_and_gzip_on_card(card):
    """The card's box builds the host runtime; gzip framing and the host
    engine's decode run there (a memoryview, as in the reference)."""
    from zlibng_tpu_torch import native
    assert native.available()
    data = pigz()[:300000]
    gz = compress_cuda(data, 6, wbits=31, device=card)
    assert gzip.decompress(gz) == data
    out = decompress_cuda(gz, wbits=31, engine="host", device=card)
    assert isinstance(out, memoryview) and out == data


DECODE_ENTRIES = {
    "decompress_cuda": lambda: decompress_cuda(zlib.compress(b"x" * 99)),
    "decompress_cuda, host engine": lambda: decompress_cuda(
        zlib.compress(b"x" * 99), engine="host"),
    "inflate_raw_cuda": lambda: inflate.inflate_raw_cuda(b"\x03\x00"),
    "decompress_segments_cuda": lambda: inflate.decompress_segments_cuda(
        b"\x03\x00", [0]),
    "decompress_indexed_cuda": lambda: index.decompress_indexed_cuda(
        b"\x03\x00", index.StreamIndex([0, 2], [0, 0], 0)),
    "adler32_cuda": lambda: checksum.adler32_cuda(b"abc"),
    "crc32_cuda": lambda: checksum.crc32_cuda(b"abc"),
}


@pytest.mark.parametrize("name", sorted(DECODE_ENTRIES))
def test_decode_entries_default_to_cuda(monkeypatch, name):
    fn = {"decompress_cuda": decompress_cuda,
          "decompress_cuda, host engine": decompress_cuda,
          "inflate_raw_cuda": inflate.inflate_raw_cuda,
          "decompress_segments_cuda": inflate.decompress_segments_cuda,
          "decompress_indexed_cuda": index.decompress_indexed_cuda,
          "adler32_cuda": checksum.adler32_cuda,
          "crc32_cuda": checksum.crc32_cuda}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (dict(inflate.stats), parse.launches)
    with pytest.raises(RuntimeError, match="cuda"):
        DECODE_ENTRIES[name]()
    assert (dict(inflate.stats), parse.launches) == before


@functools.lru_cache(maxsize=None)
def _decode_streams() -> dict:
    data = pigz()[:200000]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush()
    dct = sample("text", 20000)
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, 0, dct)
    with_dict = co.compress(data) + co.flush()
    return {"L0": (zlib.compress(data, 0), {}, data),
            "L1": (zlib.compress(data, 1), {}, data),
            "L6": (zlib.compress(data, 6), {}, data),
            "L9 runs": (zlib.compress(sample("runs", 150000), 9), {},
                        sample("runs", 150000)),
            "port L6": (compress_cuda(data, 6, device="cpu"), {}, data),
            "gzip": (gzip.compress(data[:30000]), dict(wbits=31),
                     data[:30000]),
            "raw": (raw, dict(wbits=-15), data),
            "dictionary": (with_dict, dict(dictionary=dct), data)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["L0", "L1", "L6", "L9 runs", "port L6",
                                  "gzip", "raw", "dictionary"])
def test_decode_on_card_matches_cpu(card, name):
    stream, kw, want = _decode_streams()[name]
    n0 = parse.launches
    got = decompress_cuda(stream, engine="device", device=card, **kw)
    assert got == want
    assert got == decompress_cuda(stream, engine="device", device="cpu", **kw)
    assert name == "L0" or parse.launches > n0


@pytest.mark.gpu
def test_indexed_decode_on_card_matches_cpu(card):
    data = pigz() + sample("a16", 100000) + sample("zeros", 50000)
    blob, idx = chip_smoke.indexed_blob(data, 1 << 17)
    ok = inflate.stats["device_ok"]
    n0 = parse.launches
    assert index.decompress_indexed_cuda(blob, idx, device=card) == data
    assert inflate.stats["device_ok"] == ok + 1
    assert parse.launches - n0 == inflate.decode_stats["phase_a"]
    assert index.decompress_indexed_cuda(blob, idx, device="cpu") == data


@pytest.mark.gpu
def test_decode_errors_on_card_match_cpu(card):
    base = zlib.compress(pigz()[:60000], 6)
    for flip in (300, 1000, len(base) - 6, len(base) - 1):
        c = bytearray(base)
        c[flip] ^= 0xFF
        errs = []
        for dev in (card, "cpu"):
            try:
                decompress_cuda(bytes(c), device=dev)
                errs.append(None)
            except DataError as e:
                # the wave engine's cause too: the card's phase A rejected
                # the body where the CPU's did
                errs.append((str(e), inflate.decode_stats["fallback_cause"]))
        assert errs[0] == errs[1] and errs[0] is not None, flip


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 300000])
def test_checksums_on_card(card, n):
    data = sample("pigz", n)
    assert checksum.adler32_cuda(data, device=card) == zlib.adler32(data)
    assert checksum.crc32_cuda(data, device=card) == zlib.crc32(data)
    assert checksum.crc32_cuda(data, 77, device=card) == zlib.crc32(data, 77)
