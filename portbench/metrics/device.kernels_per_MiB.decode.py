"""device.kernels_per_MiB.decode: device events (kernels, copies, fills)
of the traced requests per MiB of their output."""
from portbench.readers import kernels_per_mib


def read(rec):
    return kernels_per_mib(rec, "decode", "bytes_out")
