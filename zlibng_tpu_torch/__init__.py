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
"""
from .ops.deflate import compress_cuda
from .ops.inflate import decompress_cuda

__all__ = ["compress_cuda", "decompress_cuda"]
