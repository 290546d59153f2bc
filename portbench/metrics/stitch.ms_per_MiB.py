"""stitch.ms_per_MiB: the host stitch and framing (host clock, fetch of
the packed units included) in ms per MiB of input, over the window."""
from portbench.readers import stage_ms_per_mib


def read(rec):
    return stage_ms_per_mib(rec, "stitch")
