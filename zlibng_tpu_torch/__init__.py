"""zlibng_tpu_torch — the PyTorch/CUDA port of zlibng_tpu for NVIDIA Hopper.

`compress_cuda` is the counterpart of `zlibng_tpu.ops.deflate_tpu.
compress_tpu` and gives byte-identical output on what it covers (levels
2-9, strategies 0-3, inputs of at least 1024 bytes). It runs on the card
unless the caller passes device="cpu". Its two kernels, the probe sweep
(K1) and the parse walk (K2), are hand-written CUDA C++ under `csrc/`,
built with nvcc at first use (`_build.py`).
"""
from .ops.deflate import compress_cuda

__all__ = ["compress_cuda"]
