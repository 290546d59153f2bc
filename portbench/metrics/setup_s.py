"""setup_s: seconds from the process's start to the window's start:
interpreter, imports, CUDA's start, the kernels' build or load, the data,
the archive and the warm-up of every shape the mix uses."""


def read(rec):
    return rec["setup_s"]
