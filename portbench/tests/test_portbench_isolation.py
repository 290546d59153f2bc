"""Nothing the benchmark's command runs loads JAX or the JAX package,
compared by whole top-level name (the port's name begins with the JAX
package's)."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "zlibng_tpu"}


def test_sources_import_nothing_forbidden():
    for path in PB.rglob("*.py"):
        if "tests" in path.relative_to(PB).parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_run_loads_nothing_forbidden():
    """A dry run of every cell on the CPU, in a fresh interpreter, then
    the run's own check of sys.modules."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(PB / 'tests')!r})
from portbench import harness
from small import SMALL, small_data
harness.make_data = small_data
sys.argv = ["run.py"]
import importlib.util
spec = importlib.util.spec_from_file_location("run", {str(PB / 'run.py')!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
for wl, ov in SMALL.items():
    harness.run_cell(wl, 5, 0.05, True,
                     time.perf_counter(), device="cpu", overrides=ov,
                     log=lambda s: None)
print("FORBIDDEN", run.forbidden_modules())
print("PORT", "zlibng_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout and "PORT True" in out.stdout


def test_the_runs_check_compares_whole_names(monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location("run_mod", PB / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setitem(sys.modules, "zlibng_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "zlibng_tpu.ops", object())
    assert run.forbidden_modules() == ["zlibng_tpu"]
