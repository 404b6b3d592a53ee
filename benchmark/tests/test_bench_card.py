"""Tests that need the card (marked ``cuda``; each skips without one):

    python -m pytest -q benchmark/tests/test_bench_card.py

The reference on the card, whose steps replay a captured CUDA graph, reads
as the same reference on the CPU, step by step in eager torch; and a short
run of a cell through run.py prints a correct result."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import fields, meshgen, reference

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pathline", [False, True])
def test_graph_reference_matches_eager_cpu(card, pathline):
    arrays = meshgen.build(3000, 12, seed=1, jitter=0.05)
    kw = {"omega": 1e-5, "omega_decay": 1.0, "w_scale": 1e-3,
          "bathymetry_amp": 0.5, "shelf_lon": 0.3}
    params = [kw, dict(kw, omega=1.2e-5)][:2 if pathline else 1]
    traj = {"delta_t": 600 if pathline else 120, "duration": 600 * 48
            if pathline else 120 * 60, "record_t": 3600 if pathline else 360}
    rng = np.random.default_rng(3)
    v = rng.normal(size=(256, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * 6371010.0
    depths = rng.uniform(10, 500, 256).astype(np.float32)
    out = {}
    for dev in ("cpu", card):
        mesh = reference.mesh_from_arrays(arrays, dev)
        snaps = [reference.preprocess(mesh, fields.solid_body(
            mesh.cell_xyz, 12, p)) for p in params]
        out[str(dev)] = reference.trajectories(mesh, snaps, seeds, depths,
                                               traj)
    for key in out["cpu"]:
        np.testing.assert_allclose(out["cuda"][key], out["cpu"][key],
                                   rtol=1e-9, atol=1e-4)


@pytest.mark.cuda
def test_short_run_is_correct(card):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ec60-remap-3601", "--seed", str(2 ** 31 + 99), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
