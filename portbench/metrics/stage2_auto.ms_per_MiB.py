"""stage2_auto.ms_per_MiB: stage 2 on the auto path (partition DP,
Huffman tables, render and pack) in ms of device time per MiB of input,
over the window; only where the configuration takes that path."""
from portbench.readers import stage_ms_per_mib


def read(rec):
    return stage_ms_per_mib(rec, "stage2", quick=False)
