"""A measurement never falls back to the CPU, and a checkout that holds only
the benchmark cannot pass for a run."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def no_card() -> bool:
    import torch
    return not torch.cuda.is_available()


@pytest.mark.parametrize("cell", ["ec60-streamline-day", "ec60-remap-3601"])
def test_run_without_a_card_fails_with_no_result(cell):
    if not no_card():
        pytest.skip("a card is present: the run would measure")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_unknown_workload_fails():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "no-such-cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    """BENCHMARK.json and benchmark/ without the program: the run stops
    before a result (here driven on the CPU past the card check)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    code = ("import sys, time; sys.path[:0] = [%r]\n"
            "from benchmark import harness\n"
            "harness.execute('ec60-streamline-day', 1, 1.0, False, "
            "time.perf_counter(), device='cpu')\n" % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "mops_tpu_torch" in proc.stderr
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
