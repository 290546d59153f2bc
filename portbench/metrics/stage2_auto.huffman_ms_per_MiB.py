"""stage2_auto.huffman_ms_per_MiB: stage 2 auto's Huffman build (two
`huff_table` builds, `dyn_header`, the exact block-type choice: the span
`stage2.huffman`, device time) in ms per MiB of input, over the window;
left out where the program has no such span."""
from portbench.readers import compress_cuda_calls, stage_ms_per_mib

SPAN = "stage2.huffman"


def read(rec):
    calls = compress_cuda_calls(rec)
    if not calls or any(SPAN not in c["stage"] for c in calls):
        return None
    return stage_ms_per_mib(rec, SPAN, quick=False)
