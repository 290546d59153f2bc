"""zlibng_tpu_torch — the PyTorch/CUDA port of zlibng_tpu for NVIDIA Hopper.

`compress_cuda` is the counterpart of `zlibng_tpu.ops.deflate_tpu.
compress_tpu` and gives byte-identical output for every argument that
function takes: levels -1 to 9 and above, strategies 0-4 (L1 and Z_FIXED
through the fixed-tree quick path), every windowBits, preset dictionaries,
any `tune` (chains beyond 64 through the deep probes) and inputs of any
size (level 0 and inputs under 1024 bytes on the host encoder). It runs on
the card unless the caller passes device="cpu". Its two kernels, the probe
sweep (K1) and the parse walk (K2), are hand-written CUDA C++ under
`csrc/`, built with nvcc at first use (`_build.py`).

`decompress_cuda` is the counterpart of `zlibng_tpu.ops.inflate_tpu.
decompress_tpu`: zlib/gzip/raw decode with the same output, error text and
`stats` counts, its phase A walking the bit steps on K2. Beside it:
`ops.inflate.inflate_raw_cuda` and `decompress_segments_cuda`,
`parallel.index.decompress_indexed_cuda` (full-flush segments in lockstep
waves), and the device checksums `ops.checksum.adler32_cuda` and
`crc32_cuda`. Every entry point runs on the card unless given
device="cpu".

The sharded paths are the counterparts of `zlibng_tpu.parallel.sharded`
and `zlibng_tpu.parallel.multihost`: `compress_multichip` and
`decompress_segments_multichip` split lanes and segments across a sequence
of devices (default: every visible card; ["cpu"] * k runs k shards on the
CPU, [cuda:0] * k runs k on one card), giving the reference's bytes for the
same shard count; `parallel.multihost.multihost_compress` and
`multihost_decompress_segments` run them across the ranks of a
torch.distributed process group. The host runtime (`native/`, C built at
first use) carries the checksums, the host Huffman builds and the serial
decoder, each with a numpy route where no C compiler is found.
"""
from .ops.deflate import compress_cuda
from .ops.inflate import decompress_cuda
from .parallel.sharded import (
    compress_multichip, decompress_segments_multichip,
)

__all__ = ["compress_cuda", "compress_multichip", "decompress_cuda",
           "decompress_segments_multichip"]
