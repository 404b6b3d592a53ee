"""The port's streamline slice end to end against the JAX float64 oracle,
``mops_tpu.run_advection(..., use_pallas=False)`` under x64, on the same
mesh, fields, seeds and settings.

Tolerances: positions 1e-6 m and velocities 1e-10 m/s (float64 summation
order only); depths 1e-3 m (depth is carried in float32, whose ulp is
~5e-4 m at 4 km); alive flags and final cells equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def particles(mesh):
    """64 seeds over +-60 deg at depths 10..4500 m (the deepest below the
    4 km bottom), two of them dead (cell -1)."""
    rng = np.random.default_rng(9)
    n = 64
    lat = np.deg2rad(rng.uniform(-60, 60, n))
    lon = np.deg2rad(rng.uniform(-180, 180, n))
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(lat, lon))
    cells = mt.CellSearch(mesh).query(seeds)
    cells[[5, 40]] = -1
    depths = np.linspace(10.0, 4500.0, n).astype(np.float32)
    return seeds, cells, depths


def _settings(mod, method, direction, fail_mode, depths):
    return mod.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=depths, method=getattr(mod.CalcMethod, method),
        direction=getattr(mod.CalcDirection, direction),
        fail_mode=getattr(mod.FailMode, fail_mode))


def _assert_raw_close(port, ref):
    c = lambda t: t.cpu().numpy()
    np.testing.assert_allclose(c(port.points), np.asarray(ref.points),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(c(port.velocities), np.asarray(ref.velocities),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(c(port.final_position),
                               np.asarray(ref.final_position), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(c(port.final_depth),
                               np.asarray(ref.final_depth), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(c(port.alive), np.asarray(ref.alive))
    np.testing.assert_array_equal(c(port.final_cell),
                                  np.asarray(ref.final_cell))


@pytest.mark.parametrize("fail_mode", ["FREEZE", "ZERO"])
@pytest.mark.parametrize("direction", ["FORWARD", "BACKWARD"])
@pytest.mark.parametrize("method", ["RK4", "EULER"])
def test_slice_matches_jax_oracle(mesh, sol, particles, method, direction,
                                  fail_mode):
    seeds, cells, depths = particles
    ref_cfg = _settings(mt, method, direction, fail_mode, depths)
    ref = mt.run_advection(mesh, sol, seeds, cells, ref_cfg, use_pallas=False)
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    cfg = _settings(mtt, method, direction, fail_mode, depths)
    for use_kernel in (True, False):
        port = mtt.run_advection(pmesh, psol, seeds, cells, cfg,
                                 use_kernel=use_kernel, device="cpu")
        assert port.points.dtype == torch.float64
        _assert_raw_close(port, ref)
    # the run moved particles and some failed or died somewhere
    assert np.asarray(ref.alive).sum() >= 2
    lines = mtt.finalize_trajectories(seeds, port.points.numpy(),
                                      port.velocities.numpy(), cfg)
    ref_lines = mt.finalize_trajectories(seeds, np.asarray(ref.points),
                                         np.asarray(ref.velocities), ref_cfg)
    assert len(lines) == len(ref_lines) == len(seeds)
    for a, b in zip(lines, ref_lines):
        np.testing.assert_allclose(a.points, b.points, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.velocity, b.velocity, rtol=0, atol=1e-10)
        assert a.depth == b.depth


def test_float32_run_tracks_float64(mesh, sol, particles):
    """A float32 run of the kernel path stays within metres of float64 over
    12 steps (ulp at Earth radius is 0.5 m)."""
    seeds, cells, depths = particles
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    cfg = _settings(mtt, "RK4", "FORWARD", "ZERO", depths)
    r64 = mtt.run_advection(pmesh, psol, seeds, cells, cfg, device="cpu")
    r32 = mtt.run_advection(pmesh, psol, seeds, cells, cfg,
                            dtype=torch.float32, device="cpu")
    assert r32.points.dtype == torch.float32
    err = (r32.final_position.double() - r64.final_position).norm(dim=1)
    live = r64.alive.numpy()
    assert float(err[live].median()) < 5.0


def test_pathline_and_clamp_options_raise(mesh, sol, particles):
    """The kernel path refuses the parallel clamp; pathline (back=...) runs,
    and with one snapshot as both it is that snapshot's streamline up to the
    layer search (the same positions wherever both searches agree)."""
    seeds, cells, depths = particles
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    cfg = _settings(mtt, "RK4", "FORWARD", "ZERO", depths)
    with pytest.raises(ValueError):
        mtt.run_advection(pmesh, psol, seeds, cells, cfg, exact_clamp=False,
                          device="cpu")
    with pytest.raises(ValueError):
        mtt.run_advection(pmesh, psol, seeds, cells, cfg, back=psol,
                          exact_clamp=False, device="cpu")
    path = mtt.run_advection(pmesh, psol, seeds, cells, cfg, back=psol,
                             device="cpu")
    assert path.attrs.shape == path.points.shape
    assert bool(path.attrs.abs().sum() > 0)      # temperature and salinity
    stream = mtt.run_advection(pmesh, psol, seeds, cells, cfg, device="cpu")
    assert stream.attrs is None
    err = (path.final_position - stream.final_position).norm(dim=1)
    assert float(err[path.alive & stream.alive].median()) < 1e-6


def test_cummin_clamp_matches_jax(mesh, sol, particles):
    """The plain path's parallel clamp form (exact_clamp=False)."""
    seeds, cells, depths = particles
    cfg = _settings(mtt, "RK4", "FORWARD", "ZERO", depths)
    ref = mt.run_advection(mesh, sol, seeds, cells,
                           _settings(mt, "RK4", "FORWARD", "ZERO", depths),
                           exact_clamp=False, use_pallas=False)
    port = mtt.run_advection(mesh_from_jax(mesh), solution_from_jax(sol),
                             seeds, cells, cfg, exact_clamp=False,
                             use_kernel=False, device="cpu")
    _assert_raw_close(port, ref)


def test_float32_containment_near_edges_matches_float64():
    """Points 5 m inside a cell edge are inside at float32 as at float64:
    the edge test cross(A - p, B - p) . p does not cancel the way
    cross(A, B) . p does with 6.4e6-m coordinates (which misplaces edge
    planes by tens of metres and strands particles there)."""
    from mops_tpu_torch.advect import _gather_cell_vertices
    from mops_tpu_torch.step import _in_mesh
    pmesh = mtt.synth.build_voronoi_mesh(20000, jitter=0.05, seed=3,
                                         n_layers=2).to("cpu", torch.float64)
    cells = torch.arange(0, pmesh.n_cells, 10)
    vids, nv, _ = _gather_cell_vertices(pmesh, cells)
    vpos = pmesh.vertex_xyz[vids.long()]
    mid = 0.5 * (vpos[:, 0] + vpos[:, 1])
    inward = pmesh.cell_xyz[cells] - mid
    pos = mid + 5.0 * inward / inward.norm(dim=1, keepdim=True)
    lane_valid = torch.arange(vids.shape[1])[None, :] < nv[:, None]
    for real in (torch.float64, torch.float32):
        assert bool(_in_mesh(pos.to(real), vpos.to(real), nv,
                             lane_valid).all())


def test_cummin_clamp_pathline_matches_jax(mesh, sol, sol_back, particles):
    """The plain pathline path with the parallel clamp form, attributes
    included (1e-8, test_advect.py's pathline attribute tolerance)."""
    seeds, cells, depths = particles
    cfg = _settings(mtt, "RK4", "FORWARD", "ZERO", depths)
    ref = mt.run_advection(mesh, sol, seeds, cells,
                           _settings(mt, "RK4", "FORWARD", "ZERO", depths),
                           back=sol_back, exact_clamp=False, use_pallas=False)
    port = mtt.run_advection(mesh_from_jax(mesh), solution_from_jax(sol),
                             seeds, cells, cfg,
                             back=solution_from_jax(sol_back),
                             exact_clamp=False, use_kernel=False,
                             device="cpu")
    _assert_raw_close(port, ref)
    np.testing.assert_allclose(port.attrs.numpy(), np.asarray(ref.attrs),
                               rtol=0, atol=1e-8)
    assert bool(port.attrs.abs().sum() > 0)


def test_port_imports_no_jax():
    """The port runs a tiny streamline with jax never imported."""
    code = (
        "import sys, torch, numpy as np, mops_tpu_torch as mtt\n"
        "torch.set_num_threads(1)\n"
        "mesh = mtt.synth.build_voronoi_mesh(200, n_layers=4)\n"
        "raw = mtt.synth.solid_body_fields(mesh, 4)\n"
        "sol = mtt.preprocess(mesh, raw, device='cpu')\n"
        "seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(\n"
        "    sample_range=(4, 4), lat_range=(-30, 30), lon_range=(-30, 30)))\n"
        "cells = mtt.CellSearch(mesh).query(seeds)\n"
        "cfg = mtt.TrajectorySettings(delta_t=600, simulation_duration=3000,\n"
        "                             record_t=600)\n"
        "out = mtt.run_advection(mesh, sol, seeds, cells, cfg, device='cpu')\n"
        "lines = mtt.finalize_trajectories(seeds, out.points.numpy(),\n"
        "                                  out.velocities.numpy(), cfg)\n"
        "assert len(lines) == len(seeds) and bool(out.alive.any())\n"
        "for f in (lambda: mtt.preprocess(mesh, raw),\n"
        "          lambda: mtt.run_advection(mesh, sol, seeds, cells, cfg)):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA card' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('ran on the CPU without device=cpu')\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('mops_tpu.') or m == 'mops_tpu'\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    for root, _, files in os.walk(os.path.join(REPO, "mops_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "import jax" not in src, f
                assert "from jax" not in src, f
                assert "import mops_tpu\n" not in src, f
                assert "from mops_tpu " not in src, f
                assert "from mops_tpu." not in src, f
