"""The benchmark of zlibng_tpu_torch on NVIDIA cards; see README.md."""
