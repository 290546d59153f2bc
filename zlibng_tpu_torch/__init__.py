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
from .checksum.adler32 import adler32, adler32_combine
from .checksum.crc32 import (
    crc32, crc32_combine, crc32_combine_gen, crc32_combine_op,
)
from .errors import (
    BufError, DataError, Error, NeedDictError, StreamError,
)
from .stream.deflate import (
    Z_DEFAULT_STRATEGY, Z_FILTERED, Z_FIXED, Z_HUFFMAN_ONLY, Z_RLE,
    compress, compress_bound,
)
from .stream.inflate import decompress, gzip_decompress

# zng.py reads both: defined before any module that could import it
__version__ = "0.1.0"
ZLIBNG_PARITY_VERSION = "2.2.2"  # capability target (zlib-ng.h.in:51)

from .stream.api import (                                        # noqa: E402
    Deflate, Inflate, Z_BLOCK, Z_FINISH, Z_FULL_FLUSH, Z_NO_FLUSH,
    Z_PARTIAL_FLUSH, Z_SYNC_FLUSH, Z_TREES,
)
from .stream.gzfile import GzFile, gzdopen, gzopen               # noqa: E402
from .ops.deflate import compress_cuda                           # noqa: E402
from .ops.inflate import decompress_cuda                         # noqa: E402
from .parallel.sharded import (                                  # noqa: E402
    compress_multichip, decompress_segments_multichip,
)
