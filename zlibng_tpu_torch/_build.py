"""Builds, loads and launches the port's CUDA kernels (`csrc/*.cu`).

Each source compiles with nvcc into its own shared library with a plain C
interface, at first use, into `_build/` beside this file, under a name keyed
by a hash of the source and the flags; a later process reuses it. Libraries
are loaded with ctypes. A missing nvcc or a failed build raises: there is
no other route to the kernels. Every kernel launches through `launch`, on
its card's current stream, and its wrapper checks its tensors with
`check_cuda` (or, for inputs read in place as row-strided views,
`check_rows`); a new kernel needs its `.cu` file, a `_SIGNATURES` entry
whose last argument is the stream, and a wrapper that checks its shapes,
allocates its outputs and calls `launch`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .trace import count

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("probe", "parse", "huffman", "flat_luts", "bitpack", "render")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

# C signatures: pointers as c_void_p (a bare int would be cut to 32 bits)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "probe": ("zng_probe_best", [_P] * 7 + [_I] * 10 + [_P]),
    "parse": ("zng_parse_select", [_P] * 5 + [_I] * 2 + [_P]),
    "huffman": ("zng_huff_build", [_P] * 9 + [_I] * 2 + [_P]),
    "flat_luts": ("zng_flat_luts", [_P] * 3 + [_I] * 3 + [_P]),
    "bitpack": ("zng_bitpack", [_P] * 5 + [_I] * 3 + [_P]),
    "render": ("zng_render", [_P, _L, _L] * 4 + [_P] * 4 + [_I] + [_P] * 3
               + [_I] * 5 + [_P]),
}

_lock = threading.Lock()
_funcs: dict[str, object] = {}
# launches of each kernel so far in this process (a caller may reset them)
launches = dict.fromkeys(KERNELS, 0)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", DEFAULT_NVCC]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of zlibng_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns {name: seconds} for the ones
    built; the ptxas report of each lands in `_build/<name>.log`."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp, out)
    took, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        took[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_bytes(log)
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n"
                          + log.decode(errors="replace"))
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)       # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return took


def kernel(name: str):
    """The ctypes entry of kernel `name`, building its library if needed."""
    with _lock:
        fn = _funcs.get(name)
        if fn is None:
            build([name])
            sym, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(library_path(name))), sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _funcs[name] = fn
        return fn


def check_cuda(what: str, *tensors, dtype=torch.int32,
               dev: torch.device | None = None) -> torch.device:
    """The card of `tensors`, which must be contiguous CUDA tensors of
    `dtype` on one card, `dev` when given (ValueError otherwise). A kernel
    reads its inputs as they are: no cast, so no launch."""
    dev = tensors[0].device if dev is None else dev
    for t in tensors:
        if t.dtype != dtype or not t.is_contiguous() or not t.is_cuda \
                or t.device != dev:
            raise ValueError(f"{what} takes contiguous "
                             f"{str(dtype).removeprefix('torch.')} CUDA "
                             "tensors on one card")
    return dev


def check_rows(what: str, *tensors, dtypes,
               dev: torch.device | None = None) -> torch.device:
    """The card of `tensors`, which must be CUDA tensors on one card
    (`dev` when given), each of one of `dtypes`, and each (R, N) or
    (B, Q, N) rows whose elements are adjacent (unit stride inside a row;
    the other strides as they are: views are read in place); ValueError
    otherwise. No cast and no copy, so no launch."""
    dev = tensors[0].device if dev is None else dev
    for t in tensors:
        if t.dtype not in dtypes or not t.is_cuda or t.device != dev \
                or t.dim() not in (2, 3) \
                or (t.shape[-1] > 1 and t.stride(-1) != 1):
            names = " or ".join(str(d).removeprefix("torch.")
                                for d in dtypes)
            raise ValueError(f"{what} takes {names} CUDA tensors on one "
                             "card, (R, N) or (B, Q, N) rows of unit stride")
    return dev


def launch_count(name: str):
    """A wrapper module's `__getattr__` that gives kernel `name`'s
    `launches` as the module attribute `launches` (`probe.launches`)."""
    def getattr_(attr: str):
        if attr == "launches":
            return launches[name]
        raise AttributeError(f"no attribute {attr!r}")
    return getattr_


def launch(name: str, dev: torch.device, *args) -> None:
    """Launches kernel `name` on the current stream of card `dev` (made
    current only when it is not already), with `args` in the order of its
    C signature before the stream: a tensor passes its data pointer, an int
    itself. The raw stream handle skips torch's Stream object, whose cost
    is as long as a short kernel. Raises on a launch error; counts the
    launch in `launches` and in the trace counter `<name>.launches`."""
    fn = _funcs.get(name) or kernel(name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if dev.index == torch.cuda.current_device():
        err = fn(*ptrs, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*ptrs, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{name} kernel: CUDA error {err} at launch")
    launches[name] += 1
    count(f"{name}.launches")
