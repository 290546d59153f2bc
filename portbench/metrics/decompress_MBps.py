"""decompress_MBps: output bytes of every decode request that returned in
the window, over the window's whole length, in MB (1e6 B) per second."""


def read(rec):
    if rec["judged_as"] != "decode":
        return None
    done = sum(c["bytes_out"] for c in rec["calls"] if c["err"] is None)
    return done / rec["window_s"] / 1e6
