"""No run loads JAX or the JAX package, and the yardstick's files import
nothing of either, nor of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
# The yardstick: what decides a result without the program.
REFERENCE_FILES = ["reference.py", "check.py", "cost.py", "fields.py",
                   "meshgen.py", "traffic.py"]


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("name", REFERENCE_FILES)
def test_reference_files_import_no_program(name):
    tops = imported_tops(BENCH / name)
    assert not tops & {"jax", "jaxlib", "flax", "mops_tpu", "mops_tpu_torch"}


@pytest.mark.parametrize("path", sorted((BENCH / "metrics").glob("*.py")),
                         ids=lambda p: p.name)
def test_readers_import_no_program(path):
    tops = imported_tops(path)
    assert not tops & {"jax", "jaxlib", "flax", "mops_tpu", "mops_tpu_torch"}


@pytest.mark.parametrize("loaded, found", [
    (["mops_tpu_torch", "mops_tpu_torch.advect", "jaxtyping"], []),
    (["mops_tpu.advect"], ["mops_tpu"]),
    (["jax.numpy", "flax"], ["flax", "jax"]),
    (["jaxlib"], ["jaxlib"]),
])
def test_forbidden_compares_top_level_names_whole(monkeypatch, loaded, found):
    fake = {name: None for name in loaded}
    monkeypatch.setattr(sys, "modules", {**{k: v for k, v in sys.modules.items()
                                            if k.split(".")[0] not in
                                            harness.FORBIDDEN}, **fake})
    assert harness.forbidden_modules() == found


def test_a_run_loads_no_jax(tmp_path):
    """A whole run on the CPU, in a fresh interpreter: afterwards no module
    whose top-level name is jax, jaxlib, flax or mops_tpu is loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench_support\n"
        "from pathlib import Path\n"
        "bench_support.run_cpu('ec60-streamline-day', Path(%r))\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print('LOADED', sorted(tops & {'jax', 'jaxlib', 'flax', "
        "'mops_tpu', 'mops_tpu_torch'}))\n"
        % (str(ROOT), str(BENCH / "tests"), str(tmp_path)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED ['mops_tpu_torch']" in proc.stdout
