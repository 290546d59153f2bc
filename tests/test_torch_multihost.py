"""The port's multi-process sharded paths (`zlibng_tpu_torch/parallel/
multihost.py`): two gloo ranks over localhost, each holding 4 CPU shards
(tests/torch_mh_worker.py, which imports only the port). Rank 0's stream
must equal the JAX package's `compress_multichip` on its 8-device virtual
CPU mesh at the same lane_block, and every rank must decode the indexed
segments to the input through the sharded decode, with no fallback."""
import zlib

import jax
import numpy as np
from jax.sharding import Mesh

from zlibng_tpu.parallel.sharded import compress_multichip

from torch_corpus import sample, synthetic
from torch_mh_worker import run_ranks

LANE_BLOCK = 16384


def test_two_rank_gloo_compress_and_decode(tmp_path):
    data = (sample("pigz", 50000) + synthetic("a256", 20000, seed=8)
            + sample("text", 30000))
    blob, decoded, moves = run_ranks(data, tmp_path, world=2, shards=4,
                                     lane_block=LANE_BLOCK)
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    assert blob == compress_multichip(data, mesh, level=6,
                                      lane_block=LANE_BLOCK)
    assert zlib.decompress(blob) == data
    for dec, moved in zip(decoded, moves):
        assert dec == data
        assert moved["mesh_ok"] == 1 and moved["fallback"] == 0
