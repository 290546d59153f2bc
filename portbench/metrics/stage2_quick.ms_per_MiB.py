"""stage2_quick.ms_per_MiB: stage 2 on the fixed-tree quick path (L1,
Z_FIXED) in ms of device time per MiB of input, over the window; only
where the configuration takes that path."""
from portbench.readers import stage_ms_per_mib


def read(rec):
    return stage_ms_per_mib(rec, "stage2", quick=True)
