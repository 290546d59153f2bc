"""The PyTorch port stands alone: `zlibng_tpu_torch`, every submodule and
chip_smoke.py import with JAX blocked, and load nothing of JAX or of the
JAX package."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
for m in [m for m in sys.modules
          if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
    del sys.modules[m]
sys.modules["jax"] = None        # any import of jax now raises
import zlibng_tpu_torch
names = [m.name for m in pkgutil.walk_packages(zlibng_tpu_torch.__path__,
                                               "zlibng_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if (m.startswith("jax") and sys.modules[m] is not None)
       or m == "zlibng_tpu" or m.startswith("zlibng_tpu.")]
print(len(names), "MODULES")
print("DECODE", all(f"zlibng_tpu_torch.{m}" in names for m in (
    "ops.inflate", "ops.checksum", "parallel.index", "stream.inflate_serial",
    "huffman.decode_tables")))
print("BAD", sorted(bad))
"""


def test_port_imports_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "BAD []", out.stdout
    assert lines[-2] == "DECODE True", out.stdout   # the decode slice too
    assert int(lines[-3].split()[0]) >= 30    # every module was imported


PROBE_NEW = r"""
import sys
for m in [m for m in sys.modules
          if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
    del sys.modules[m]
sys.modules["jax"] = None        # any import of jax now raises
from zlibng_tpu_torch import native
from zlibng_tpu_torch.parallel import multihost, sharded
print("ENTRY", callable(sharded.compress_multichip),
      callable(sharded.decompress_segments_multichip),
      callable(multihost.multihost_compress), callable(native.lib))
bad = [m for m in sys.modules
       if (m.startswith("jax") and sys.modules[m] is not None)
       or m == "zlibng_tpu" or m.startswith("zlibng_tpu.")]
print("BAD", sorted(bad))
"""


def test_native_and_sharded_modules_import_nothing_of_jax():
    """The host runtime and the sharded and multi-process modules, imported
    first and alone."""
    out = subprocess.run([sys.executable, "-c", PROBE_NEW], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "BAD []", out.stdout
    assert lines[-2] == "ENTRY True True True True", out.stdout
