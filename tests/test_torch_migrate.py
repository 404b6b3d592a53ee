"""The port's domain-decomposed engine with migration against
mops_tpu.parallel.migrate on 8 CPU shards (the conftest's 8 virtual CPU
devices on the JAX side, ``["cpu"] * 8`` on the port's).

Both run at float64.  mops_tpu's engine steps through its XLA stage
evaluation with the parallel ztop clamp (migrate.py's exact_clamp=False),
so the port runs its plain path with exact_clamp=False against it; its
window path exists in mops_tpu for float32 Pallas only, so the port's
float64 window run (W = 4 at L = 6) is held to the same full-column
reference.  Tolerances are test_torch_advect.py's (positions 1e-6 m,
velocities 1e-10 m/s) and 1e-8 for attributes; migrated and dropped
counts and each shard's final id set are equal.  Each particle sees the
single-device run's operations on the same values, so every migrating run
also equals the port's own run_advection bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu.parallel import migrate as jmig
from mops_tpu.parallel.decompose import partition_cells
from mops_tpu_torch import advect
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax
from mops_tpu_torch.parallel import reassemble, run_advection_migrating

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
# JAX reference runs: (pathline, migrate_every, fail mode).
CASES = {"stream": (False, 1, "ZERO"), "stream_k3": (False, 3, "ZERO"),
         "path": (True, 2, "ZERO"), "freeze": (False, 1, "FREEZE")}


@pytest.fixture(scope="module")
def particles(mesh):
    """64 seeds over +-60 deg at depths 10..3000 m."""
    rng = np.random.default_rng(11)
    n = 64
    lat = np.deg2rad(rng.uniform(-60, 60, n))
    lon = np.deg2rad(rng.uniform(-180, 180, n))
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(lat, lon))
    cells = mt.CellSearch(mesh).query(seeds)
    depths = np.linspace(10.0, 3000.0, n).astype(np.float32)
    return seeds, cells, depths


def _cfg(mod, depths, fail_mode="ZERO", steps=24):
    return mod.TrajectorySettings(
        delta_t=3600, simulation_duration=3600 * steps, record_t=3600 * 4,
        particle_depths=depths, fail_mode=getattr(mod.FailMode, fail_mode))


def _band(mesh, dlon_deg):
    """64 equatorial seeds dlon_deg west of shard 1's west edge (8 shards)
    and their cells, as tests/test_migrate.py places them."""
    owner = partition_cells(mesh, 8)
    cx = np.asarray(mesh.cell_xyz)
    lon_c = np.arctan2(cx[:, 1], cx[:, 0])
    lons = np.full(64, lon_c[owner == 1].min() - np.deg2rad(dlon_deg))
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.zeros(64), lons))
    return seeds, mt.CellSearch(mesh).query(seeds)


def _jax(mesh, sol, seeds, cells, cfg, **kw):
    res = jmig.run_advection_migrating(mesh, sol, seeds, cells, cfg,
                                       dtype=jnp.float64, **kw)
    return res, jmig.reassemble(res, len(seeds), seeds)


@pytest.fixture(scope="module")
def jax_runs(mesh, sol, sol_back, particles):
    """mops_tpu's float64 migrating runs, computed once: the CASES, and the
    forced send overflow and seed-time pool truncation of
    tests/test_migrate.py (:248, :277)."""
    seeds, cells, depths = particles
    out = {}
    for name, (pathline, k, fail_mode) in CASES.items():
        out[name] = _jax(mesh, sol, seeds, cells,
                         _cfg(mt, depths, fail_mode),
                         back=sol_back if pathline else None,
                         migrate_every=k, capacity_factor=4.0)
    seeds_o, cells_o = _band(mesh, 0.5)
    out["overflow"] = _jax(mesh, sol, seeds_o, cells_o,
                           _cfg(mt, None, steps=30), send_capacity=1,
                           capacity_factor=9.0)
    seeds_t, cells_t = _band(mesh, 5.0)
    out["truncation"] = _jax(mesh, sol, seeds_t, cells_t,
                             _cfg(mt, None, steps=4))
    return out


def _id_sets(res):
    ids = np.asarray(res.final_ids.cpu() if hasattr(res.final_ids, "cpu")
                     else res.final_ids)
    return [sorted(row[row >= 0].tolist()) for row in ids]


def _assert_counts_equal(got, ref):
    for f in ("migrated", "dropped"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert _id_sets(got) == _id_sets(ref)


def _check(got, ref, single, pathline, fail_mode):
    """``got`` (the port's migrating run) against mops_tpu's ``ref`` and the
    port's single-device run ``single``.  Under FREEZE a particle stops when
    a stage leaves its cell, so it never leaves its shard."""
    res, (points, vels, attrs, fpos, fdepth) = got
    jres, (jpoints, jvels, jattrs, jfpos, _) = ref
    assert int(res.dropped.sum()) == 0
    assert (int(res.migrated.sum()) > 0) == (fail_mode == "ZERO")
    _assert_counts_equal(res, jres)
    np.testing.assert_allclose(points.numpy(), jpoints, rtol=0, atol=1e-6)
    np.testing.assert_allclose(fpos.numpy(), jfpos, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vels.numpy(), jvels, rtol=0, atol=1e-10)
    if pathline:
        np.testing.assert_allclose(attrs.numpy(), jattrs, rtol=0, atol=1e-8)
        assert torch.equal(attrs, single.attrs)
    # bit for bit the single-device run (slot 0 of a point record is the
    # seed, here and there)
    assert torch.equal(points, single.points)
    assert torch.equal(vels, single.velocities)
    assert torch.equal(fpos, single.final_position)
    assert torch.equal(fdepth, single.final_depth)


def _port(mesh, sol, sol_back, seeds, cells, cfg, pathline, **kw):
    back = solution_from_jax(sol_back) if pathline else None
    res = run_advection_migrating(mesh_from_jax(mesh), solution_from_jax(sol),
                                  seeds, cells, cfg, devices=CPU8,
                                  dtype=torch.float64, back=back, **kw)
    single_kw = {k: v for k, v in kw.items()
                 if k in ("use_kernel", "exact_clamp", "use_window")}
    single = mtt.run_advection(mesh_from_jax(mesh), solution_from_jax(sol),
                               seeds, cells, cfg, back=back, device="cpu",
                               **single_kw)
    return (res, reassemble(res, len(seeds), seeds)), single


@pytest.mark.parametrize("name", list(CASES))
def test_migrating_equals_jax_and_single_device(mesh, sol, sol_back,
                                                particles, jax_runs, name):
    seeds, cells, depths = particles
    pathline, k, fail_mode = CASES[name]
    got, single = _port(mesh, sol, sol_back, seeds, cells,
                        _cfg(mtt, depths, fail_mode), pathline,
                        migrate_every=k, capacity_factor=4.0,
                        use_kernel=False, exact_clamp=False)
    assert got[0].rec_attr is None or pathline
    _check(got, jax_runs[name], single, pathline, fail_mode)


@pytest.mark.parametrize("name", ["stream", "path"])
def test_migrating_window_path(mesh, sol, sol_back, particles, jax_runs,
                               name, monkeypatch):
    """The window path (the default on the card; here its plain version)
    with carried layers riding the exchange, at W = 4 (WINDOW_LAYERS) so
    that L = 6 has windows to miss."""
    monkeypatch.setattr(advect, "WINDOW_LAYERS", 4)
    seeds, cells, depths = particles
    pathline, k, fail_mode = CASES[name]
    got, single = _port(mesh, sol, sol_back, seeds, cells,
                        _cfg(mtt, depths, fail_mode), pathline,
                        migrate_every=k, capacity_factor=4.0,
                        use_window=True)
    assert single.window_misses is not None
    assert int(got[0].window_misses.sum()) == int(single.window_misses.sum())
    _check(got, jax_runs[name], single, pathline, fail_mode)


def test_equator_band_migrates(mesh, sol):
    """Seeds along the equator cross the longitude sectors without loss
    (tests/test_migrate.py:216)."""
    lons = np.deg2rad(np.linspace(-179, 179, 64))
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.zeros(64), lons))
    cells = mt.CellSearch(mesh).query(seeds)
    res = run_advection_migrating(
        mesh_from_jax(mesh), solution_from_jax(sol), seeds, cells,
        _cfg(mtt, None, steps=30), devices=CPU8, dtype=torch.float64)
    assert int(res.dropped.sum()) == 0 and int(res.migrated.sum()) > 0
    ids = _id_sets(res)
    assert sorted(sum(ids, [])) == list(range(64))
    owner = partition_cells(mesh, 8)
    end = np.zeros(64, dtype=int)
    for p, row in enumerate(ids):
        end[row] = p
    assert (owner[cells] != end).any(), "no particle changed shard"


@pytest.mark.parametrize("name", ["overflow", "truncation"])
def test_losses_counted_as_jax_counts_them(mesh, sol, jax_runs, name):
    """send_capacity=1 on 64 seeds that cross a sector boundary together,
    and 64 seeds that start in one shard whose pool holds 32: every lost
    particle is counted, survivors are unique, and both counts and id sets
    are mops_tpu's."""
    if name == "overflow":
        seeds, cells = _band(mesh, 0.5)
        kw = dict(send_capacity=1, capacity_factor=9.0)
        cfg = _cfg(mtt, None, steps=30)
    else:
        seeds, cells = _band(mesh, 5.0)
        kw = {}
        cfg = _cfg(mtt, None, steps=4)
    res = run_advection_migrating(
        mesh_from_jax(mesh), solution_from_jax(sol), seeds, cells, cfg,
        devices=CPU8, dtype=torch.float64, **kw)
    survivors = sum(_id_sets(res), [])
    dropped = int(res.dropped.sum())
    assert dropped > 0
    assert len(survivors) == len(set(survivors))
    assert len(survivors) + dropped == 64
    _assert_counts_equal(res, jax_runs[name][0])
