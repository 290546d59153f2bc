"""stage1.ms_per_MiB: stage 1 (lz77_lane, K1, K2, unit_freqs) in ms of
device time (the program's CUDA events, `ops/deflate.py:stage_seconds`)
per MiB of input, summed over the window's compress_cuda calls."""
from portbench.readers import stage_ms_per_mib


def read(rec):
    return stage_ms_per_mib(rec, "stage1")
