"""mops_tpu_torch modules vs their mops_tpu originals on the same inputs.

The jax-free copies (settings, synth, trajectory, record_schedule) must be
equal; the tensor ports (geo, interp, preprocess) must match JAX x64 at
1e-12 relative (atol 1e-12 of the field's largest magnitude, so exact zeros
compare too); the cell search must be equal.
"""

import dataclasses
import warnings
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax
from mops_tpu_torch.utils.timer import TimerManager

torch.set_num_threads(1)

_MESH_FIELDS = ("cell_xyz", "vertex_xyz", "edge_xyz", "n_edges_on_cell",
                "vertices_on_cell", "cells_on_cell", "cells_on_vertex",
                "edges_on_cell", "cells_on_edge", "vertices_on_edge",
                "ref_bottom_depth")


def _close(port, ref, rtol=1e-12):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = float(np.nanmax(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * scale)


def _assert_mesh_equal(port, ref):
    for f in _MESH_FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
        assert a.numpy().dtype == np.asarray(b).dtype, f


# --- jax-free copies: equal -------------------------------------------------

def test_settings_copy_equals_original():
    for name in ("CalcDirection", "CalcMethod", "FailMode"):
        port, ref = getattr(mtt.settings, name), getattr(mt.settings, name)
        assert [(e.name, e.value) for e in port] == \
            [(e.name, e.value) for e in ref]
    for name in ("TrajectorySettings", "SamplingSettings", "TrajectoryLine"):
        port, ref = getattr(mtt.settings, name), getattr(mt.settings, name)
        pf = [(f.name, f.default) for f in dataclasses.fields(port)]
        rf = [(f.name, f.default) for f in dataclasses.fields(ref)]
        assert [(n, getattr(d, "value", d)) for n, d in pf] == \
            [(n, getattr(d, "value", d)) for n, d in rf]
    for name in ("ONE_SECOND", "ONE_MINUTE", "ONE_HOUR", "ONE_DAY", "ONE_WEEK",
                 "ONE_MONTH", "ONE_YEAR"):
        assert getattr(mtt.settings, name) == getattr(mt.settings, name)
    for kw in (dict(depth=37.5), dict(particle_depths=np.arange(5.0) * 1.1)):
        port = mtt.TrajectorySettings(**kw).effective_depths(5)
        ref = mt.TrajectorySettings(**kw).effective_depths(5)
        assert port.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(port, ref)
    assert mtt.config.EARTH_RADIUS == mt.config.EARTH_RADIUS
    assert (mtt.config.EPS_LAYER, mtt.config.EPS_ZERO, mtt.config.ZTOP_CLAMP) \
        == (mt.config.EPS_LAYER, mt.config.EPS_ZERO, mt.config.ZTOP_CLAMP)


@pytest.mark.parametrize("kind", ["voronoi", "voronoi_jitter_land",
                                  "gradient"])
def test_synth_copy_equals_original(kind):
    if kind == "voronoi":
        args, build = (300,), "build_voronoi_mesh"
        kw = dict(n_layers=5)
    elif kind == "voronoi_jitter_land":
        args, build = (300,), "build_voronoi_mesh"
        kw = dict(n_layers=5, jitter=0.05, seed=3, land_box=(-20, 20, 0, 40))
    else:
        args, build = (300,), "build_gradient_mesh"
        kw = dict(n_layers=5)
    port = getattr(mtt.synth, build)(*args, **kw)
    ref = getattr(mt.synth, build)(*args, **kw)
    _assert_mesh_equal(port, ref)
    fkw = dict(n_layers=5, w_scale=1e-3, bathymetry_amp=0.5, shelf_lon=0.3,
               omega_decay=1.0)
    fp, fr = mtt.synth.solid_body_fields(port, **fkw), \
        mt.synth.solid_body_fields(ref, **fkw)
    assert fp.keys() == fr.keys()
    for k in fr:
        np.testing.assert_array_equal(fp[k], fr[k], err_msg=k)


def test_mesh_to_and_normalize_connectivity():
    raw = np.array([[1, 2, 0], [3, 5, 4]])
    np.testing.assert_array_equal(
        mtt.mesh._normalize_connectivity(raw, 4),
        mt.mesh._normalize_connectivity(raw, 4))
    m = mtt.synth.build_voronoi_mesh(100, n_layers=3).to("cpu", torch.float32)
    assert m.cell_xyz.dtype == m.vertex_xyz.dtype == torch.float32
    assert m.vertices_on_cell.dtype == torch.int32
    assert m.n_cells == 100 and m.max_edges == m.vertices_on_cell.shape[1]


def test_trajectory_copy_equals_original():
    rng = np.random.default_rng(2)
    n, r = 6, 5
    seeds = rng.normal(size=(n, 3))
    pts = rng.normal(size=(n, r, 3))
    vels = rng.normal(size=(n, r, 3))
    pts[1, 2, 0] = np.nan
    pts[3, 0, 1] = np.inf
    cfg_p = mtt.TrajectorySettings(record_t=120, simulation_duration=600)
    cfg_r = mt.TrajectorySettings(record_t=120, simulation_duration=600)
    lp = mtt.finalize_trajectories(seeds, pts, vels, cfg_p)
    lr = mt.finalize_trajectories(seeds, pts, vels, cfg_r)
    lp2 = mtt.remove_nan_trajectories_and_reindex(lp)
    lr2 = mt.remove_nan_trajectories_and_reindex(lr)
    for a_lines, b_lines in ((lp, lr), (lp2, lr2)):
        assert len(a_lines) == len(b_lines)
        for a, b in zip(a_lines, b_lines):
            for f in ("line_id", "duration", "timestamp", "depth"):
                assert getattr(a, f) == getattr(b, f)
            for f in ("points", "velocity", "temperature", "salinity",
                      "last_point"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _plant(cut, seeds, pts):
    """Non-finite values where ``cut`` says (R = 5 records)."""
    if cut == "seed":                 # cut 0
        seeds[2, 1] = np.nan
        seeds[4, 0] = -np.inf
    elif cut == "first":              # cut 1
        pts[1, 0, 2] = np.nan
    elif cut == "middle":
        pts[3, 2, 0] = np.inf
    elif cut == "last":               # cut R
        pts[5, 4, 1] = np.nan
    elif cut == "mixed":              # NaN and inf, a later one after a cut
        pts[0, 1, :] = np.nan
        pts[0, 3, 0] = np.inf
        pts[3, 3, 1] = -np.inf
        seeds[6, 2] = np.inf
        pts[2, 4, 2] = np.nan


_FINALIZE_CASES = [
    pytest.mark.parametrize("cut", ["none", "seed", "first", "middle",
                                    "last", "mixed"]),
    pytest.mark.parametrize("with_attrs", [False, True],
                            ids=["streamline", "attrs"]),
    pytest.mark.parametrize("dtype,source,depths", [
        (np.float32, "numpy", True), (np.float64, "numpy", False),
        (np.float32, "tensor", False), (np.float64, "tensor", True)],
        ids=["f32-numpy-depths", "f64-numpy", "f32-tensor",
             "f64-tensor-depths"])]


def _finalize_cases(fn):
    """finalize's cases: the non-finite cuts, with and without attributes,
    NumPy or tensor records of either dtype, with or without depths."""
    for mark in reversed(_FINALIZE_CASES):
        fn = mark(fn)
    return fn


def _finalize_inputs(cut, with_attrs, dtype, depths):
    """(seeds, points, velocities, attrs, TrajectorySettings kwargs) of 8
    lines of 5 records, planted with ``cut``'s non-finite values."""
    rng = np.random.default_rng(7)
    n, r = 8, 5
    seeds = rng.normal(size=(n, 3)) * 6.4e6
    pts = (rng.normal(size=(n, r, 3)) * 6.4e6).astype(dtype)
    vels = rng.normal(size=(n, r, 3)).astype(dtype)
    attrs = rng.normal(size=(n, r, 3)).astype(dtype) if with_attrs else None
    _plant(cut, seeds, pts)
    kw = dict(delta_t=60, record_t=120, simulation_duration=600)
    if depths:
        kw["particle_depths"] = np.linspace(5.0, 900.0, n)
    return seeds, pts, vels, attrs, kw


def _assert_same_lines(got, ref):
    """Every field of every line equal, bit for bit and of one type."""
    assert type(got) is list and len(got) == len(ref)
    for a, b in zip(got, ref):
        for f in ("line_id", "duration", "timestamp", "depth"):
            assert getattr(a, f) == getattr(b, f), f
            assert type(getattr(a, f)) is type(getattr(b, f)), f
        for f in ("points", "velocity", "temperature", "salinity",
                  "last_point", "attrs"):
            x, y = getattr(a, f), getattr(b, f)
            if y is None:
                assert x is None, f
                continue
            assert isinstance(x, np.ndarray), f
            assert (x.dtype, x.shape) == (y.dtype, y.shape), f
            assert x.tobytes() == y.tobytes(), (f, a.line_id)


@_finalize_cases
def test_finalize_equals_original_bit_for_bit(cut, with_attrs, dtype, source,
                                              depths):
    """The block finalize gives the original loop's lines bit for bit, as
    a list of lines whose last_point is no view of its points."""
    seeds, pts, vels, attrs, kw = _finalize_inputs(cut, with_attrs, dtype,
                                                   depths)
    ref = mt.finalize_trajectories(seeds, pts, vels,
                                   mt.TrajectorySettings(**kw), attrs=attrs,
                                   with_attrs=with_attrs)
    wrap = torch.from_numpy if source == "tensor" else (lambda a: a)
    got = mtt.finalize_trajectories(
        seeds, wrap(pts), wrap(vels), mtt.TrajectorySettings(**kw),
        attrs=None if attrs is None else wrap(attrs), with_attrs=with_attrs)
    assert len(got) == 8
    _assert_same_lines(got, ref)
    line = got[-1]
    before = line.points.copy()
    line.last_point[:] = 1.0
    assert line.points.tobytes() == before.tobytes()


def _done(result=None, exc=None) -> Future:
    """A finished future of ``result`` (or one that raised ``exc``), as
    the API's worker leaves it."""
    fut = Future()
    if exc is None:
        fut.set_result(result)
    else:
        fut.set_exception(exc)
    return fut


def _readback_counts(call):
    """(lines, {counter: count}) of ``call`` run as a request."""
    mgr = TimerManager.instance()
    with mgr.request("api.test"):
        lines = call()
    rid = [s.request for s in mgr.spans() if s.name == "api.test"][-1]
    return lines, {k: v for k, v in mgr.counters()[rid].items()
                   if k.startswith("trajectory.readback")}


@_finalize_cases
def test_finalize_into_prepared_blocks_equals_finalize_without(
        cut, with_attrs, dtype, source, depths):
    """Records copied into prepared host blocks (trajectory.host_blocks, as
    the API prepares them for a card's records) give the lines of the
    read-back into new memory bit for bit; each line's arrays are row
    views of the prepared blocks, and every block counts as ready."""
    seeds, pts, vels, attrs, kw = _finalize_inputs(cut, with_attrs, dtype,
                                                   depths)
    cfg = mtt.TrajectorySettings(**kw)
    wrap = torch.from_numpy if source == "tensor" else (lambda a: a)
    args = (seeds, wrap(pts), wrap(vels), cfg)
    kwargs = dict(attrs=None if attrs is None else wrap(attrs),
                  with_attrs=with_attrs)
    want = mtt.finalize_trajectories(*args, **kwargs)
    blocks = mtt.trajectory.host_blocks(len(seeds), cfg.n_records,
                                        with_attrs)
    got, counts = _readback_counts(lambda: mtt.finalize_trajectories(
        *args, **kwargs, host=_done(blocks)))
    _assert_same_lines(got, want)
    n_blocks = 4 if with_attrs else 2
    assert counts == {"trajectory.readback_blocks": n_blocks,
                      "trajectory.readback_ready": n_blocks}
    views = {"points": "pts", "velocity": "vel", "attrs": "att",
             "temperature": "ts", "salinity": "ts"}
    for line in got:
        for f, name in views.items():
            if name in blocks:
                assert np.shares_memory(getattr(line, f),
                                        blocks[name].numpy()), f
        assert not np.shares_memory(line.last_point, blocks["pts"].numpy())
    assert not any(b.is_pinned() for b in blocks.values())


@pytest.mark.parametrize("fault", ["missing", "shape", "dtype", "raised"])
def test_finalize_falls_back_for_an_unfit_prepared_block(fault):
    """A prepared block that is missing or of another shape or dtype takes
    the read-back into new memory and counts as not ready, the others
    their prepared blocks; a worker that raised sends every block to new
    memory with a warning.  The lines are the same either way."""
    seeds, pts, vels, attrs, kw = _finalize_inputs("mixed", True,
                                                   np.float32, True)
    cfg = mtt.TrajectorySettings(**kw)
    args = (seeds, torch.from_numpy(pts), torch.from_numpy(vels), cfg)
    kwargs = dict(attrs=torch.from_numpy(attrs), with_attrs=True)
    want = mtt.finalize_trajectories(*args, **kwargs)
    blocks = mtt.trajectory.host_blocks(len(seeds), cfg.n_records, True)
    if fault == "missing":
        del blocks["att"]
    elif fault == "shape":
        blocks["vel"] = torch.zeros(len(seeds), cfg.n_records, 3,
                                    dtype=torch.float64)
    elif fault == "dtype":
        blocks["ts"] = blocks["ts"].float()
    host = _done(exc=RuntimeError("no memory")) if fault == "raised" \
        else _done(blocks)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, counts = _readback_counts(lambda: mtt.finalize_trajectories(
            *args, **kwargs, host=host))
    _assert_same_lines(got, want)
    assert counts == {"trajectory.readback_blocks": 4,
                      "trajectory.readback_ready": 0 if fault == "raised"
                      else 3}
    assert [issubclass(w.category, RuntimeWarning) for w in caught] == (
        [True] if fault == "raised" else [])
    if fault != "raised":
        unfit = {"missing": "attrs", "shape": "velocity",
                 "dtype": "temperature"}[fault]
        for f, name in (("points", "pts"), ("velocity", "vel"),
                        ("attrs", "att"), ("temperature", "ts")):
            if name in blocks:
                assert np.shares_memory(getattr(got[0], f),
                                        blocks[name].numpy()) == (f != unfit)


@pytest.mark.parametrize("kw", [
    dict(delta_t=120, simulation_duration=86400, record_t=360),
    dict(delta_t=600, simulation_duration=600 * 14, record_t=1200,
         direction=mt.CalcDirection.BACKWARD),
    dict(delta_t=700, simulation_duration=7000, record_t=1000),
])
def test_record_schedule_copy_equals_original(kw):
    port_kw = dict(kw)
    if "direction" in kw:
        port_kw["direction"] = mtt.CalcDirection.BACKWARD
    port = mtt.advect.record_schedule(mtt.TrajectorySettings(**port_kw), False)
    ref = mt.advect.record_schedule(mt.TrajectorySettings(**kw), False)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    is_first, flags, slots, alphas, dt = mtt.advect.advection_schedule(
        mtt.TrajectorySettings(**port_kw), False)
    ref_first, ref_flags, ref_slots, ref_alphas, dt_ref = \
        mt.advect.advection_schedule(mt.TrajectorySettings(**kw), False,
                                     jnp.float64)
    for a, b in ((is_first, ref_first), (flags, ref_flags), (slots, ref_slots),
                 (alphas, ref_alphas)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert dt == float(dt_ref)


@pytest.mark.parametrize("kw", [
    dict(delta_t=600, simulation_duration=600 * 14, record_t=1200),
    dict(delta_t=600, simulation_duration=30 * 86400, record_t=6 * 3600,
         direction=mt.CalcDirection.BACKWARD),
    dict(delta_t=700, simulation_duration=7000, record_t=1000),
])
def test_pathline_schedule_and_stage_alphas_match_jax(kw):
    """The pathline schedule (alphas i / n_steps, the (i+1) % (record_t //
    delta_t) cadence) equals mops_tpu's; the stage alphas a2 and a4 equal
    mops_tpu.advect's clip(a1 + dalpha/2) and clip(a1 + dalpha) in the run
    dtype (advect.py:757-759), for float32 and float64."""
    port_kw = dict(kw)
    if "direction" in kw:
        port_kw["direction"] = mtt.CalcDirection.BACKWARD
    cfg, ref_cfg = mtt.TrajectorySettings(**port_kw), mt.TrajectorySettings(**kw)
    port = mtt.advect.advection_schedule(cfg, True)
    for real, jreal in ((torch.float64, jnp.float64),
                        (torch.float32, jnp.float32)):
        ref = mt.advect.advection_schedule(ref_cfg, True, jreal)
        for a, b in zip(port[:3], ref[:3]):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(port[3].astype(np.dtype(jreal)),
                                      np.asarray(ref[3]))
        dt = ref[4]
        assert port[4] == float(dt)
        dalpha = dt / jnp.asarray(int(ref_cfg.simulation_duration), dtype=jreal)
        a1 = ref[3]
        for i in (0, 1, len(a1) // 2, len(a1) - 1):
            got = mtt.advect.stage_alphas(port[3][i], port[4],
                                          int(cfg.simulation_duration), real)
            want = (a1[i], jnp.clip(a1[i] + 0.5 * dalpha, 0.0, 1.0),
                    jnp.clip(a1[i] + dalpha, 0.0, 1.0))
            for g, w in zip(got, want):
                assert g.dtype == np.dtype(jreal)
                assert g == np.asarray(w)


# --- tensor ports: 1e-12 relative vs JAX x64 -------------------------------

def test_geo_matches_jax():
    rng = np.random.default_rng(7)
    lat = rng.uniform(-1.5, 1.5, 64)
    lon = rng.uniform(-3.1, 3.1, 64)
    lat[0], lon[0] = np.pi / 2, 0.0                      # pole
    t = torch.from_numpy
    _close(mtt.geo.latlon_rad_to_xyz(t(lat), t(lon)),
           mt.geo.latlon_rad_to_xyz(lat, lon))
    p = np.array(mt.geo.latlon_rad_to_xyz(lat, lon))
    p[1] = [0.0, 0.0, mt.EARTH_RADIUS]                   # exact pole
    for a, b in zip(mtt.geo.xyz_to_latlon_rad(t(p)),
                    mt.geo.xyz_to_latlon_rad(p)):
        _close(a, b)
    uz, um, up = rng.normal(size=(3, 64))
    _close(mtt.geo.enu_velocity_to_xyz(t(p), t(uz), t(um), t(up)),
           mt.geo.enu_velocity_to_xyz(p, uz, um, up))
    v = rng.normal(size=(64, 3))
    theta = rng.uniform(-0.1, 0.1, 64)
    ax = mtt.geo.rotation_axis(t(p), t(v))
    _close(ax, mt.geo.rotation_axis(p, v))
    _close(mtt.geo.rotate_around_axis(t(p), ax, t(theta)),
           mt.geo.rotate_around_axis(p, np.asarray(mt.geo.rotation_axis(p, v)),
                                     theta))
    # the deliberate NaN on a zero axis is kept
    out = mtt.geo.rotate_around_axis(t(p[:1]), torch.zeros(1, 3), t(theta[:1]))
    assert torch.isnan(out).all()


def test_interp_matches_jax(mesh):
    rng = np.random.default_rng(11)
    voc = np.asarray(mesh.vertices_on_cell)
    nv = np.asarray(mesh.n_edges_on_cell)
    vxyz = np.asarray(mesh.vertex_xyz)
    cells = rng.integers(0, mesh.n_cells, 128)
    poly = vxyz[np.clip(voc[cells], 0, None)]
    p = np.asarray(mesh.cell_xyz)[cells] + rng.normal(scale=2e4, size=(128, 3))
    t = torch.from_numpy
    _close(mtt.interp.wachspress_weights(t(p), t(poly), t(nv[cells])),
           mt.interp.wachspress_weights(p, poly, nv[cells]))
    a, b, c = poly[:, 0], poly[:, 1], poly[:, 2]
    _close(mtt.interp.triangle_area(t(a), t(b), t(c)),
           mt.interp.triangle_area(a, b, c))
    for x, y in zip(mtt.interp.triangle_barycentric(t(p), t(a), t(b), t(c)),
                    mt.interp.triangle_barycentric(p, a, b, c)):
        _close(x, y)
    up = p / np.linalg.norm(p, axis=1, keepdims=True)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east, axis=1, keepdims=True)
    basis = np.stack([east, np.cross(up, east)], axis=1)  # tangent plane
    uv = rng.normal(size=(128, poly.shape[1], 3))
    valid = np.arange(poly.shape[1])[None, :] < nv[cells][:, None]
    _close(mtt.interp.rbf_plane_coefficients(
        t(poly / 1e6), t(uv), t(p), 1.0, t(basis), t(valid)),
        mt.interp.rbf_plane_coefficients(poly / 1e6, uv, p, 1.0, basis, valid))


@pytest.mark.parametrize("kind,branch", [("voronoi", "zm"), ("voronoi", "rbf"),
                                         ("gradient", "zm"),
                                         ("gradient", "rbf")])
def test_preprocess_matches_jax(kind, branch):
    build = "build_voronoi_mesh" if kind == "voronoi" else "build_gradient_mesh"
    jmesh = getattr(mt.synth, build)(400, n_layers=6)
    raw = mt.synth.solid_body_fields(jmesh, n_layers=6, w_scale=1e-3,
                                     bathymetry_amp=0.5, omega_decay=1.0)
    if branch == "rbf":
        raw = dict(raw)
        del raw["velocityZonal"], raw["velocityMeridional"]
        raw["normalVelocity"] = mt.synth.solid_body_normal_velocity(
            jmesh, n_layers=6)
    ref = mt.preprocess(jmesh, raw)
    port = mtt.preprocess(getattr(mtt.synth, build)(400, n_layers=6), raw,
                          device="cpu")
    for f in ("cell_ztop", "vertex_ztop", "cell_velocity", "vertex_velocity",
              "vertex_vert_velocity"):
        _close(getattr(port, f), getattr(ref, f))
    assert port.vertex_attrs.keys() == ref.vertex_attrs.keys()
    for k in ref.vertex_attrs:
        _close(port.vertex_attrs[k], ref.vertex_attrs[k])
        _close(port.cell_attrs[k], ref.cell_attrs[k])
    # from_jax carries the JAX result over unchanged
    conv = solution_from_jax(ref)
    np.testing.assert_array_equal(conv.vertex_velocity.numpy(),
                                  np.asarray(ref.vertex_velocity))
    _assert_mesh_equal(mesh_from_jax(jmesh), jmesh)


def test_cellsearch_and_seeding_match_jax(mesh):
    rng = np.random.default_rng(4)
    cfg = dict(sample_range=(12, 9), lat_range=(-60, 60), lon_range=(-170, 170))
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(**cfg))
    ref_seeds = mt.seeding.generate_sample_points(mt.SamplingSettings(**cfg))
    _close(seeds, ref_seeds)
    np.testing.assert_array_equal(
        mtt.seeding.linear_depth_profile(17, 10, 500),
        mt.seeding.linear_depth_profile(17, 10, 500))
    pts = np.concatenate([ref_seeds, rng.normal(size=(50, 3)) * 6e6])
    port_mesh = mesh_from_jax(mesh)
    np.testing.assert_array_equal(mtt.CellSearch(port_mesh).query(pts),
                                  mt.CellSearch(mesh).query(pts))
