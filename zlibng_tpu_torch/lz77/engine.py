"""Match-engine constants shared with `zlibng_tpu/lz77/engine.py`."""

HASH_MULT = 2654435761   # 4-byte multiplicative hash (Knuth), kept mod 2^32
TOO_FAR = 4096  # emit literal instead of len-3 match beyond this (deflate.h analog)
