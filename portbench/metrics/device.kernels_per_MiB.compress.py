"""device.kernels_per_MiB.compress: device events (kernels, copies, fills)
of the traced requests per MiB of their input."""
from portbench.readers import kernels_per_mib


def read(rec):
    return kernels_per_mib(rec, "compress", "bytes_in")
