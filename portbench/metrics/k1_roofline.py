"""k1_roofline: K1 (`csrc/probe.cu`, kernel `probe_walk`) as a share of
its byte bound: the bytes its launches need at 3.35 TB/s over the
profiler's device time of those launches, in %. The launches' shapes come
from the benchmark's frozen lane geometry; the share is left out unless
the geometry's launch count, the program's counter and the profiler's
kernel count agree."""
from portbench import geometry
from portbench.readers import device_profile, kernel_time


def read(rec):
    p = device_profile(rec, "compress")
    if p is None or not p["expected"].get("k1"):
        return None
    want = p["expected"]["k1"]
    n, sec = kernel_time(p, "probe_walk")
    if not sec or n != len(want) or p["counted"]["k1"] != len(want):
        return None
    need = sum(geometry.k1_bytes(B, N, deep) for B, N, deep in want)
    return 100.0 * need / geometry.HBM_BYTES_PER_S / sec
