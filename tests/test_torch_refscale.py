"""The port's 80-layer slice and reference-scale entries against mops_tpu on
the same numpy-seeded inputs, on the CPU.

- The L80 slice: a 400-cell mesh with 80 layers (the reference's
  eddy-resolving level count), 128 particles, 5 steps: streamline, and
  pathline with two attributes, through the port's plain path (and the
  layer-window path's plain version) at float64 against
  ``mops_tpu.run_advection(..., use_pallas=False)`` under x64.  Positions
  within 1e-6 m and velocities within 1e-10 m/s (float64 summation order
  only), depths exactly (both carry them in float32 through the same
  operations), attribute records within 1e-8 (test_advect.py's).
- ``bench_refscale`` case A at a reduced size, float64 on the CPU, against
  the JAX script's case built and run by mops_tpu at x64 (final positions
  within 1e-6 m); ``LAST_RESOLVED`` and ``step_cost``.
- ``MPASMesh.validate`` and ``SolutionFields.slim`` as mops_tpu's.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu_torch import advect, prof_dma
from mops_tpu_torch.from_jax import mesh_from_jax
from mops_tpu_torch.kernels import stage_kernel as sk
from mops_tpu_torch.scripts import bench_refscale as rs

torch.set_num_threads(1)

L80 = 80


@pytest.fixture(scope="module")
def slice80():
    """A 400-cell L80 mesh in the crossing regime, two snapshots with
    temperature and salinity, 128 seeds at 10..2500 m (numpy-seeded)."""
    mesh = mt.synth.build_voronoi_mesh(400, jitter=0.05, n_layers=L80)
    kw = dict(n_layers=L80, w_scale=1e-3, bathymetry_amp=0.5, shelf_lon=0.3,
              omega_decay=1.0)
    raws = [{k: np.asarray(v) for k, v in
             mt.synth.solid_body_fields(mesh, omega=om, **kw).items()}
            for om in (1e-5, 1.2e-5)]
    rng = np.random.default_rng(80)
    v = rng.normal(size=(128, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mt.EARTH_RADIUS
    cells = mt.CellSearch(mesh).query(seeds)
    cells[[3, 70]] = -1                                 # dead particles
    depths = np.linspace(10.0, 2500.0, 128).astype(np.float32)
    return mesh, raws, seeds, cells, depths


def _cfg(mod, depths):
    return mod.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 5, record_t=1200,
        particle_depths=depths, fail_mode=mod.FailMode.ZERO)


@pytest.fixture(scope="module")
def jax_runs(slice80):
    mesh, raws, seeds, cells, depths = slice80
    front, back = (mt.preprocess(mesh, raw) for raw in raws)
    cfg = _cfg(mt, depths)
    return {pathline: mt.run_advection(mesh, front, seeds, cells, cfg,
                                       back=back if pathline else None,
                                       use_pallas=False)
            for pathline in (False, True)}


@pytest.mark.parametrize("path", ["plain", "window"])
@pytest.mark.parametrize("pathline", [False, True],
                         ids=["streamline", "pathline"])
def test_l80_slice_matches_jax(slice80, jax_runs, pathline, path):
    mesh, raws, seeds, cells, depths = slice80
    pm = mesh_from_jax(mesh)
    front, back = (mtt.preprocess(pm, raw, device="cpu") for raw in raws)
    kw = dict(use_kernel=False) if path == "plain" else dict(use_window=True)
    got = mtt.run_advection(pm, front, seeds, cells, _cfg(mtt, depths),
                            back=back if pathline else None, device="cpu",
                            **kw)
    res = advect.LAST_RESOLVED
    assert res["instance"] == (None if path == "plain" else "generic")
    assert res["window"] == (path == "window") and res["n_attrs"] == (
        2 if pathline else 0)
    ref = jax_runs[pathline]
    c = lambda t: t.numpy()
    np.testing.assert_allclose(c(got.points), np.asarray(ref.points),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(c(got.final_position),
                               np.asarray(ref.final_position), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(c(got.velocities), np.asarray(ref.velocities),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(c(got.final_depth),
                                  np.asarray(ref.final_depth))
    np.testing.assert_array_equal(c(got.alive), np.asarray(ref.alive))
    if pathline:
        np.testing.assert_allclose(c(got.attrs), np.asarray(ref.attrs),
                                   rtol=0, atol=1e-8)
        assert float(np.abs(c(got.attrs)).max()) > 0
    # the slice crosses layers and moves
    assert int(got.alive.sum()) > 64
    assert float(np.median(np.linalg.norm(c(got.final_position) - seeds,
                                          axis=1))) > 1e3


def test_case_a_reduced_matches_jax():
    """bench_refscale case A at 2,000 cells, L80, 256 particles, 4 steps,
    float64 on the CPU, against the JAX script's build and run at x64
    (exact clamp and the plain step on both sides)."""
    n_cells, n_particles, n_steps = 2000, 256, 4
    rec, raw = rs.case_A(n_cells=n_cells, n_particles=n_particles,
                         n_steps=n_steps, device="cpu",
                         dtype=torch.float64, n_gate=64)
    assert rec["verified"] and rec["layers"] == L80
    assert rec["gate"]["lanes"] == 64 and rec["gate"]["share"] == 1.0
    assert (rec["path"]["kernel"], rec["path"]["instance"]) == ("k1", "generic")
    assert rec["path"]["dtype"] == "float64" and rec["peak_gb"] is None
    # the JAX script's build() at float64
    mesh = mt.synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=0,
                                       n_layers=L80)
    raw_f = {k: np.asarray(v, np.float32).astype(np.float64) for k, v in
             mt.synth.solid_body_fields(mesh, n_layers=L80,
                                        w_scale=1e-5).items()
             if k not in ("temperature", "salinity")}
    sol = mt.preprocess(mesh, raw_f).slim()
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n_particles, 3))
    seeds = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * mt.EARTH_RADIUS).astype(np.float32)
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=120,
                                simulation_duration=120 * n_steps,
                                record_t=120 * n_steps, depth=100.0,
                                fail_mode=mt.FailMode.ZERO)
    ref = mt.run_advection(mesh, sol, seeds.astype(np.float64), cells, cfg,
                           use_pallas=False)
    np.testing.assert_allclose(raw.final_position.numpy(),
                               np.asarray(ref.final_position), rtol=0,
                               atol=1e-6)
    assert float(np.abs(raw.final_position.numpy() - seeds).max()) > 1e3


def _counting(fn, key, repair):
    """A step wrapper that counts its calls under ``key`` as the CUDA
    wrapper counts its launches (the window ones with their repair) and
    runs ``fn``."""
    def wrapper(pos, *args, **kw):
        sk.count_launch(key, pos.dtype)
        if repair:
            sk.count_launch(f"{key} repair", pos.dtype)
        return fn(pos, *args, **kw)
    return wrapper


def test_phase_8e_rehearsal_matches_jax(monkeypatch):
    """chip_smoke.py phase 8e (pathline_month) on the CPU at 2,000 cells x
    L80, 256 seeds at 10..500 m, 6 steps, two attributes, float64, with the
    card's calls stubbed, the step wrappers counting and the window on for
    use_window=None (as on the card); 8e's one-step kernel checks run
    and hold (here each wrapper is its plain version); both paths resolve
    K2's generic instance with two attributes, the counts read 6 K4 and 6
    repairs on the window path and 6 K2 on the full column, the two paths'
    final positions agree within 1e-6 m, and both equal
    mops_tpu.run_advection(..., use_pallas=False) at x64 on the same inputs
    (positions 1e-6 m, velocities 1e-10 m/s, attribute records 1e-8)."""
    import chip_smoke as cs
    n_cells, n_steps, f32, f64 = 2000, 6, torch.float32, torch.float64
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)

    def fail(msg):
        raise AssertionError(msg)
    monkeypatch.setattr(cs, "fail", fail)
    names = {"pathline_step_kernel<float, 128, true>": 1.0,
             "pathline_step_kernel<double, 128, true>": 1.0,
             "window_pathline_kernel": 1.0}
    monkeypatch.setattr(cs, "device_breakdown",
                        lambda run: (3.0, 4.0, names, (0.0, 0.0, "")))
    for name, key, repair in (("fused_pathline_step", "k2", False),
                              ("fused_window_pathline_step", "k4", True)):
        wrapper = _counting(getattr(sk, name), key, repair)
        monkeypatch.setattr(sk, name, wrapper)
        monkeypatch.setattr(advect, name, wrapper)
    resolve = advect.resolve_window
    monkeypatch.setattr(
        advect, "resolve_window", lambda use_kernel, use_window, *a:
        resolve(use_kernel, True if use_window is None else use_window, *a))
    case = rs.build(n_cells, L80, 16, device="cpu", dtypes=(f32, f64))
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(17, 17), lat_range=(-80, 80), lon_range=(-180, 180)))
    assert len(seeds) == 256
    omegas = (prof_dma.PATH_OMEGA, prof_dma.BACK_OMEGA)
    rows = {k: {"L80": {}} for k in ("k1", "k2", "k3", "k4")}
    out, raws = cs.pathline_month(torch.device("cpu"), case, omegas, seeds,
                                  n_steps, L80, lambda name, fn: fn(), "cpu",
                                  rows, dtype=f64)
    assert rows["k4"]["L80"]["launches"] == n_steps
    assert rows["k2"]["L80"]["repair_launches"] == n_steps
    assert rows["k2"]["L80"]["launches"] == n_steps
    for label, window in (("window", True), ("full column", False)):
        path = out[f"8e {label}"]["path"]
        assert (path["instance"], path["n_attrs"], path["window"],
                path["dtype"]) == ("generic", 2, window, "float64")
    for tag in ("f32", "f64"):
        for label in ("window", "full column"):
            assert out[f"gate {tag} {label}"]["verified"]
    c = lambda t: t.numpy()
    np.testing.assert_allclose(c(raws["window"].final_position),
                               c(raws["full column"].final_position),
                               rtol=0, atol=1e-6)
    # mops_tpu on the same inputs at x64
    mesh = mt.synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=0,
                                       n_layers=L80)
    front, back = (mt.preprocess(mesh, {
        k: np.asarray(v, np.float32).astype(np.float64) for k, v in
        mt.synth.solid_body_fields(mesh, n_layers=L80, omega=om,
                                   **prof_dma.FIELD_KW).items()})
        for om in omegas)
    depths = mtt.seeding.linear_depth_profile(len(seeds), 10, 500)
    cfg = mt.TrajectorySettings(
        delta_t=cs.PATH_DT, simulation_duration=cs.PATH_DT * n_steps,
        record_t=cs.PATH_DT * n_steps, particle_depths=depths,
        fail_mode=mt.FailMode.ZERO)
    ref = mt.run_advection(mesh, front, seeds, mt.CellSearch(mesh).query(
        seeds), cfg, back=back, use_pallas=False)
    for raw in raws.values():
        for name, tol in (("points", 1e-6), ("final_position", 1e-6),
                          ("velocities", 1e-10), ("attrs", 1e-8)):
            np.testing.assert_allclose(c(getattr(raw, name)),
                                       np.asarray(getattr(ref, name)),
                                       rtol=0, atol=tol, err_msg=name)
        np.testing.assert_array_equal(c(raw.alive), np.asarray(ref.alive))
    assert float(np.abs(c(raws["window"].attrs)).max()) > 0


def test_step_cost_counts_distinct_rows(slice80):
    """advect.step_cost against a direct count: distinct vertices, and
    distinct (vertex, layer) pairs of the layers around each start depth,
    on a streamline; dead particles read nothing."""
    mesh, raws, seeds, cells, depths = slice80
    pm = mesh_from_jax(mesh)
    sol = mtt.preprocess(pm, raws[0], device="cpu")
    nbytes, ops = advect.step_cost(pm, [sol], seeds, cells, depths)
    alive = cells >= 0
    voc = pm.vertices_on_cell.numpy()[cells[alive]]
    nv = pm.n_edges_on_cell.numpy()[cells[alive]]
    valid = np.arange(voc.shape[1])[None, :] < nv[:, None]
    n_vert = len(np.unique(voc[valid]))
    vids, nvt, _ = advect._gather_cell_vertices(
        pm, torch.as_tensor(np.maximum(cells, 0)))
    w = mtt.interp.wachspress_weights(torch.as_tensor(seeds),
                                      pm.vertex_xyz[vids.long()], nvt)
    z = mtt.step._clamp_profile(torch.einsum(
        "nk,nkl->nl", w, sol.vertex_ztop[vids.long()]), True)
    layer = mtt.step._layer_search_binary(
        z, -torch.as_tensor(depths, dtype=torch.float64)).numpy()[alive]
    pairs = {(int(v), int(lay) + d) for row, ok, lay in zip(voc, valid, layer)
             for v in row[ok] for d in (-1, 0)}
    n, size = len(seeds), 8
    want = (n_vert * 3 * size + n_vert * L80 * size + len(pairs) * 4 * size
            + n * (4 * size + 4) + 4 * int(nv.sum())
            + n * (7 * size + 1))
    assert nbytes == want
    assert ops == 4 * float((85 * nv + 2 * nv * (L80 + 8)).sum())


def test_last_resolved_records_each_run(slice80):
    mesh, raws, seeds, cells, depths = slice80
    pm = mesh_from_jax(mesh)
    sol = mtt.preprocess(pm, raws[0], device="cpu")
    cfg = dataclasses.replace(_cfg(mtt, depths), simulation_duration=1200)
    expect = {"kernel", "window", "n_window", "pathline", "n_attrs", "dtype",
              "instance"}
    mtt.run_advection(pm, sol, seeds, cells, cfg, device="cpu",
                      use_window=True, dtype=torch.float32)
    first = dict(advect.LAST_RESOLVED)
    assert set(first) == expect
    assert (first["kernel"], first["window"], first["n_window"],
            first["dtype"], first["instance"]) == (
        "k3", True, advect.WINDOW_LAYERS, "float32", "generic")
    # the bench's record adds the step's least bytes (after a timed run)
    case = types.SimpleNamespace(seeds=seeds, cells=cells)
    st, sols = advect.prepare(pm, sol, None, cfg, torch.float32, "cpu",
                              use_window=True)
    path = rs.path_record(st.mesh, sols, case, cfg)
    assert path == {**first, "step_bytes": advect.step_cost(
        st.mesh, sols, seeds, cells, cfg.effective_depths(len(seeds)), 0,
        advect.WINDOW_LAYERS)[0]} and path["step_bytes"] > 0
    mtt.run_advection(pm, sol, seeds, cells, cfg, device="cpu",
                      use_kernel=False)
    assert (advect.LAST_RESOLVED["kernel"], advect.LAST_RESOLVED["window"],
            advect.LAST_RESOLVED["instance"]) == (None, False, None)
    assert sk.column_instance(64) == "64" \
        and sk.column_instance(65) == "generic"


def test_validate_matches_jax(mesh):
    """MPASMesh.validate passes where mops_tpu's does and raises the same
    exception type where it fails."""
    pm = mesh_from_jax(mesh)
    mesh.validate()
    pm.validate()
    cases = {
        "vertex id out of range": ("vertices_on_cell", lambda a: (
            a.__setitem__((0, 0), mesh.n_vertices), a)[1]),
        "cell id below -1": ("cells_on_vertex", lambda a: (
            a.__setitem__((1, 1), -2), a)[1]),
        "zero edges": ("n_edges_on_cell", lambda a: (
            a.__setitem__(2, 0), a)[1]),
        "too many edges": ("n_edges_on_cell", lambda a: (
            a.__setitem__(2, mesh.max_edges + 1), a)[1]),
        "wrong shape": ("cells_on_vertex", lambda a: a[:, :2].copy()),
    }
    for what, (field, bad) in cases.items():
        arr = bad(np.array(getattr(mesh, field)))
        with pytest.raises(AssertionError):
            dataclasses.replace(mesh, **{field: arr}).validate()
        with pytest.raises(AssertionError):
            dataclasses.replace(pm, **{field: torch.from_numpy(arr)}
                                ).validate()


def test_slim_matches_jax(mesh, raw_fields):
    """SolutionFields.slim keeps one row of the cell tables and no cell
    attributes, as mops_tpu's; a slimmed streamline runs as the full one,
    and a slimmed pair records no attributes (mops_tpu's gate)."""
    pm = mesh_from_jax(mesh)
    full = mtt.preprocess(pm, raw_fields, device="cpu")
    slim = full.slim()
    ref = mt.preprocess(mesh, raw_fields).slim()
    assert tuple(slim.cell_ztop.shape) == tuple(np.shape(ref.cell_ztop))
    assert tuple(slim.cell_velocity.shape) == \
        tuple(np.shape(ref.cell_velocity))
    assert slim.cell_attrs == {} and ref.cell_attrs == {}
    assert set(slim.vertex_attrs) == set(ref.vertex_attrs)
    assert slim.n_layers == full.n_layers
    assert torch.equal(slim.vertex_velocity, full.vertex_velocity)
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad([10.0, -20.0]),
                                                np.deg2rad([30.0, 100.0])))
    cells = mtt.CellSearch(pm).query(seeds)
    cfg = mtt.TrajectorySettings(delta_t=600, simulation_duration=3600,
                                 record_t=1200, depth=50.0)
    a = mtt.run_advection(pm, full, seeds, cells, cfg, device="cpu")
    b = mtt.run_advection(pm, slim, seeds, cells, cfg, device="cpu")
    assert torch.equal(a.points, b.points)
    path = mtt.run_advection(pm, slim, seeds, cells, cfg, back=slim,
                             device="cpu")
    assert advect.LAST_RESOLVED["n_attrs"] == 0
    assert not bool(path.attrs.any())


def test_window_step_parts_from_full_step_on_an_ascending_column():
    """The layer-window fault on ascending columns (found by the gate's
    tracing) and its repair.  Where a cell's interpolated raw ztop profile
    ascends above the window (a vertex column reaching above the surface in
    the crossing regime's synthetic field), the full column's sequential
    clamp chains the whole column into a plateau near the surface value,
    while the window clamps from its own top value.  At float32 the 1e-9
    clamp is below the resolution of the window's plateau (|z| ~ 3 m), so
    the window step alone fails a stage where the full step passes, with no
    edge miss: the trajectories part.  mops_tpu's window kernel takes that
    side on this lane (tests/window_fault_mops_tpu.py).  The port's window
    step flags it as a clamp miss (the cell's first rise lies above the
    window's start), and its repair gives the full step's outputs bit for
    bit, at float32 and float64, through K3's plain version and through
    K4's on a pathline between the case's snapshot and itself; the window
    step alone still loses its fourth stage (about 5/6 of the full
    velocity).  The gate's tracing then finds no lane off."""
    from mops_tpu_torch.interp import wachspress_weights
    from mops_tpu_torch.step import (cell_rise, start_layer, window_cols,
                                     window_starts, window_streamline_step)
    mesh, sol, seeds, cells = mtt.bench.build_case(
        3000, 60, 2048, device="cpu", **mtt.bench.CROSSING)
    depths = mtt.seeding.linear_depth_profile(2048, 10, 2500)
    cfg = mtt.TrajectorySettings(delta_t=120, simulation_duration=2400,
                                 record_t=2400, particle_depths=depths)
    j = 644
    for real in (torch.float32, torch.float64):
        st, sols = advect.prepare(mesh, sol, None, cfg, real, "cpu",
                                  use_window=True)
        p = advect.start_particles(st, sols, seeds, cells, depths,
                                   cfg.n_records)
        L = st.n_layers
        pos, dn = p.pos[j:j + 1], (-p.depth[j:j + 1]).to(real)
        vids, nv, _ = advect._gather_cell_vertices(st.mesh, p.cell[j:j + 1])
        s = window_starts(p.layer[j:j + 1], L, st.n_window).contiguous()
        assert int(p.layer[j]) == L - 1 and int(s[0]) > 0  # below the bottom
        assert int(cell_rise(st.rise, vids, nv)[0]) <= int(s[0])
        full = sk.fused_streamline_step_plain(pos, dn, nv, vids, st.table, L,
                                              st.dt)
        win = sk.fused_window_streamline_step_plain(
            pos, dn, nv, vids, s, st.table, st.rise, L, st.n_window, st.dt)
        assert bool(full[3][0]) and bool(win[5][0]) and bool(win[6][0])
        for a, b in zip(win[:4], full):
            assert torch.equal(a, b)
        # K4 on a pathline between the snapshot and itself
        tab2 = sk.pack_vertex_table(st.mesh.vertex_xyz, sols[0].vertex_ztop,
                                    sols[0].vertex_velocity,
                                    sols[0].vertex_vert_velocity)
        alphas = advect.stage_alphas(0.5, st.dt, cfg.simulation_duration,
                                     real)
        fullp = sk.fused_pathline_step_plain(pos, dn, nv, vids, st.table,
                                             tab2, L, st.dt, alphas)
        vpos, cols = sk._split_rows(st.table, vids, L, 0)
        sp = window_starts(start_layer(cols[0], pos, dn, nv, vpos, True), L,
                           st.n_window)
        winp = sk.fused_window_pathline_step_plain(
            pos, dn, nv, vids, sp.contiguous(), st.table, tab2, st.rise,
            sk.table_rise(tab2, L), L, st.n_window, st.dt, alphas)
        assert bool(winp[5][0]) and bool(winp[6][0])
        for a, b in zip(winp[:4], fullp[:4]):
            assert torch.equal(a, b)
        if real == torch.float32:
            # the window step alone (the parent's, and mops_tpu's window
            # kernel's): its fourth stage's profile ascends everywhere and
            # the stage fails, so it keeps about 5/6 of the full velocity
            alone = window_streamline_step(
                tuple(window_cols(c, s, st.n_window) for c in cols),
                (cols[0][..., 0], cols[0][..., -1]), s, L, pos, dn, nv,
                vpos, st.dt, False, cell_rise(st.rise, vids, nv))
            rows = st.table[vids.long()]
            p4 = pos + full[1] * st.dt
            z4 = torch.einsum("nk,nkl->nl", wachspress_weights(
                p4, rows[..., :3], nv), rows[..., 3:3 + L])
            assert bool((z4[0, 1:] > z4[0, :-1]).all())
            assert not bool(alone[3][0])
            torch.testing.assert_close(alone[1], full[1] * 5 / 6, rtol=1e-3,
                                       atol=0)
    # the gate's tracing: no lane off, none parted from identical states
    g = mtt.bench.gate(mesh, sol, seeds, cells, dataclasses.replace(
        cfg, fail_mode=mtt.FailMode.ZERO), device="cpu", use_window=True,
        trace=True)
    assert (g["off"], g["identical_start"], g["off_kinds"]["same_cell"]) \
        == (0, 0, 0) and g["verified"]
