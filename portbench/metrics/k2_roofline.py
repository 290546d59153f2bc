"""k2_roofline: K2 on the encode parse (`csrc/parse.cu`, kernels
`parse_speculate` and `parse_stitch`, one of each per launch) as a share
of its byte bound (int32 steps and bounds read once, the mask written
once) at 3.35 TB/s over their profiled device time, in %. Left out unless
the frozen geometry's launch count, the program's counter and the
profiler's kernel counts agree."""
from portbench import geometry
from portbench.readers import device_profile, kernel_time


def read(rec):
    p = device_profile(rec, "compress")
    if p is None or not p["expected"].get("k2"):
        return None
    want = p["expected"]["k2"]
    n1, s1 = kernel_time(p, "parse_speculate")
    n2, s2 = kernel_time(p, "parse_stitch")
    if not (s1 + s2) or not n1 == n2 == p["counted"]["k2"] == len(want):
        return None
    need = sum(geometry.k2_bytes(B, N) for B, N in want)
    return 100.0 * need / geometry.HBM_BYTES_PER_S / (s1 + s2)
