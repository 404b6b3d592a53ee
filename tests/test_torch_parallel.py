"""The port's particle-sharded engine, decomposition, run_advection's
chunk=, BucketGrid and vertex_velocity_zm against mops_tpu on the CPU.

Shards are CPU devices (``["cpu"] * 8``, the counterpart of the 8 virtual
CPU devices of the conftest).  Each particle sees the single-device run's
operations on the same values, so the sharded and chunked runs must equal
the port's single-device run bit for bit; against mops_tpu at float64 they
are held to test_torch_advect.py's tolerances (positions 1e-6 m,
velocities 1e-10 m/s: float64 summation order only).  Decomposition and
the bucket table are plain numpy copies, so they must be equal.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu.parallel import decompose as jdec
from mops_tpu.parallel import device_mesh
from mops_tpu.parallel import run_advection_sharded as jsharded
from mops_tpu_torch import api as papi
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax
from mops_tpu_torch.parallel import (decompose, device_list, partition_cells,
                                     run_advection_sharded, shard_particles)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
_RAW_FIELDS = ("points", "velocities", "attrs", "final_position",
               "final_depth", "final_cell", "alive", "window_misses")


@pytest.fixture(scope="module")
def particles(mesh):
    """64 seeds over +-60 deg at depths 10..4500 m, two of them dead."""
    rng = np.random.default_rng(9)
    n = 64
    lat = np.deg2rad(rng.uniform(-60, 60, n))
    lon = np.deg2rad(rng.uniform(-180, 180, n))
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(lat, lon))
    cells = mt.CellSearch(mesh).query(seeds)
    cells[[5, 40]] = -1
    depths = np.linspace(10.0, 4500.0, n).astype(np.float32)
    return seeds, cells, depths


def _cfg(mod, depths, **kw):
    return mod.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=depths, fail_mode=mod.FailMode.ZERO, **kw)


def _assert_raw_equal(got, want):
    for f in _RAW_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def _assert_raw_close(port, ref):
    c = lambda t: t.cpu().numpy()
    np.testing.assert_allclose(c(port.points), np.asarray(ref.points),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(c(port.velocities), np.asarray(ref.velocities),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(c(port.final_position),
                               np.asarray(ref.final_position), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(c(port.alive), np.asarray(ref.alive))
    if ref.attrs is not None:
        np.testing.assert_allclose(c(port.attrs), np.asarray(ref.attrs),
                                   rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def jax_runs(mesh, sol, sol_back, particles):
    """mops_tpu's float64 references, computed once: the 8-device sharded
    streamline and pathline, and the chunked streamline."""
    seeds, cells, depths = particles
    cfg = _cfg(mt, depths)
    dmesh = device_mesh(8)
    return {
        "stream": jsharded(mesh, sol, seeds, cells, cfg, dmesh=dmesh),
        "path": jsharded(mesh, sol, seeds, cells, cfg, dmesh=dmesh,
                         back=sol_back),
        "chunk": mt.run_advection(mesh, sol, seeds, cells, cfg,
                                  use_pallas=False, chunk=24)}


@pytest.mark.parametrize("halo", [1, 3])
def test_decompose_equals_jax(mesh, sol, sol_back, halo):
    np.testing.assert_array_equal(partition_cells(mesh_from_jax(mesh), 4),
                                  jdec.partition_cells(mesh, 4))
    af = np.array(mt.advect.stacked_vertex_attrs(sol))
    ab = np.array(mt.advect.stacked_vertex_attrs(sol_back))
    ref = jdec.decompose(mesh, sol, 4, halo_rings=halo, back=sol_back,
                         attrs_front=af, attrs_back=ab)
    got = decompose(mesh_from_jax(mesh), solution_from_jax(sol), 4,
                    halo_rings=halo, back=solution_from_jax(sol_back),
                    attrs_front=torch.from_numpy(af), attrs_back=ab)
    for f in ref.__dataclass_fields__:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_device_list_and_shard_particles(monkeypatch):
    assert device_list(3, "cpu") == [torch.device("cpu")] * 3
    parts = shard_particles(CPU8[:3], np.arange(8), np.arange(16).reshape(8, 2))
    assert [p.tolist() for p in parts[0]] == [[0, 1, 2], [3, 4, 5], [6, 7]]
    assert [tuple(p.shape) for p in parts[1]] == [(3, 2), (3, 2), (2, 2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device_list(2) == [torch.device("cuda", 0),
                              torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="3 devices asked for.* 2 CUDA"):
        device_list(3)


@pytest.mark.parametrize("kind", ["stream", "path"])
def test_sharded_equals_single_device_and_jax(mesh, sol, sol_back, particles,
                                             jax_runs, kind):
    seeds, cells, depths = particles
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    back = solution_from_jax(sol_back) if kind == "path" else None
    cfg = _cfg(mtt, depths)
    single = mtt.run_advection(pmesh, psol, seeds, cells, cfg, back=back,
                               device="cpu")
    got = run_advection_sharded(pmesh, psol, seeds, cells, cfg,
                                devices=CPU8, back=back)
    _assert_raw_equal(got, single)
    _assert_raw_close(got, jax_runs[kind])


def test_sharded_window_path_and_fewer_particles_than_shards(mesh, sol,
                                                              particles):
    """The window path (W = 4 at L = 6) shards bit-equal too, and with 5
    particles on 8 shards the empty shards run nothing."""
    seeds, cells, depths = particles
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    for n in (64, 5):
        cfg = _cfg(mtt, depths[:n])
        kw = dict(use_window=True, window=4)
        single = mtt.run_advection(pmesh, psol, seeds[:n], cells[:n], cfg,
                                   device="cpu", **kw)
        got = mtt.run_advection(pmesh, psol, seeds[:n], cells[:n], cfg,
                                devices=CPU8, **kw)
        assert got.window_misses is not None
        _assert_raw_equal(got, single)


def test_chunk_equals_unchunked_and_jax(mesh, sol, particles, jax_runs):
    seeds, cells, depths = particles
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    cfg = _cfg(mtt, depths)
    whole = mtt.run_advection(pmesh, psol, seeds, cells, cfg, device="cpu")
    for chunk in (24, 64, 100):
        got = mtt.run_advection(pmesh, psol, seeds, cells, cfg, device="cpu",
                                chunk=chunk)
        _assert_raw_equal(got, whole)
    _assert_raw_close(got, jax_runs["chunk"])


@pytest.mark.parametrize("devices,chunk", [(3, 7), (8, 5), (2, None)],
                         ids=["3x7", "8x5", "2"])
def test_devices_and_chunk_pack_tables_once(mesh, sol, particles, devices,
                                            chunk, monkeypatch):
    """Shards run their slices in chunks, one after another, against one
    set of tables a distinct device: the whole run bit for bit."""
    seeds, cells, depths = particles
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    cfg = _cfg(mtt, depths)
    whole = mtt.run_advection(pmesh, psol, seeds, cells, cfg, device="cpu")
    built = []
    make = mtt.advect.make_stepper
    monkeypatch.setattr(mtt.advect, "make_stepper",
                        lambda *a, **k: built.append(1) or make(*a, **k))
    got = mtt.run_advection(pmesh, psol, seeds, cells, cfg, chunk=chunk,
                            devices=CPU8[:devices])
    assert len(built) == 1
    _assert_raw_equal(got, whole)


def test_no_particles(mesh, sol):
    """An empty run gives empty outputs of the right shapes, sharded or
    not."""
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    cfg = _cfg(mtt, None)
    empty = np.zeros((0, 3)), np.zeros(0, dtype=np.int32)
    for got in (mtt.run_advection(pmesh, psol, *empty, cfg, device="cpu"),
                run_advection_sharded(pmesh, psol, *empty, cfg,
                                      devices=CPU8)):
        assert tuple(got.points.shape) == (0, cfg.n_records, 3)
        assert tuple(got.final_position.shape) == (0, 3)


def _app(mesh, raw_fields, devices):
    app = papi.MOPSApp()
    app.init("cpu", precision="fp64", devices=devices)
    app.begin()
    app.add_grid(mesh_from_jax(mesh))
    app.add_solution(1, {k: np.asarray(v) for k, v in raw_fields.items()})
    app.end()
    app.active_attribute(1)
    return app


def test_api_devices_option(mesh, raw_fields):
    """MOPSApp.init(devices=8) splits every trajectory run over 8 CPU
    shards and gives the lines of devices=1 bit for bit."""
    one, eight = _app(mesh, raw_fields, 1), _app(mesh, raw_fields, 8)
    cpu = torch.device("cpu")
    assert eight.devices == [cpu] * 8 and one.devices == [cpu]
    seeds = one.generate_sample_points(mtt.SamplingSettings(
        sample_range=(4, 4), lat_range=(-30, 30), lon_range=(-60, 60),
        depth=100.0))
    cfg = mtt.TrajectorySettings(delta_t=600, simulation_duration=600 * 6,
                                 record_t=1200)
    lines1 = one.run_streamline(cfg, seeds.copy())
    lines8 = eight.run_streamline(cfg, seeds.copy())
    assert len(lines1) == len(lines8) == len(seeds)
    for a, b in zip(lines1, lines8):
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.velocity, b.velocity)


def test_cli_devices_flag(tmp_path):
    from mops_tpu_torch import cli
    args = ["--synthetic", "400", "--layers", "5", "--remap-size", "24x12",
            "--samples", "4x4", "--duration", "3600", "--dt", "600",
            "--record", "1200", "--device", "cpu"]
    for nd in ("1", "2"):
        assert cli.main(args + ["--devices", nd, "--out",
                                str(tmp_path / nd)]) == 0
    for name in ("streamline.txt", "streamline.vtp"):
        assert (tmp_path / "2" / name).read_bytes() \
            == (tmp_path / "1" / name).read_bytes()


def test_bucket_grid_equals_jax_and_cell_search(mesh):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(3000, 3))
    pts = v / np.linalg.norm(v, axis=1, keepdims=True) * mt.EARTH_RADIUS
    ref = mt.BucketGrid.build(mesh)
    pmesh = mesh_from_jax(mesh)
    grid = mtt.BucketGrid.build(pmesh)
    assert (grid.n_lat, grid.n_lon) == (ref.n_lat, ref.n_lon)
    np.testing.assert_array_equal(grid.table.numpy(), np.asarray(ref.table))
    got = grid.query(pmesh, torch.from_numpy(pts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.query(mesh, jnp.asarray(pts))))
    np.testing.assert_array_equal(got.numpy(),
                                  mtt.CellSearch(pmesh).query(pts))


def test_vertex_velocity_zm_matches_jax(mesh):
    rng = np.random.default_rng(4)
    zon = rng.normal(size=(mesh.n_vertices, 6))
    mer = rng.normal(size=(mesh.n_vertices, 6))
    ref = np.asarray(mt.solution.vertex_velocity_zm(
        mesh, jnp.asarray(zon), jnp.asarray(mer)))
    got = mtt.solution.vertex_velocity_zm(
        mesh_from_jax(mesh), torch.from_numpy(zon), torch.from_numpy(mer))
    assert got.shape == (mesh.n_vertices, 6, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
