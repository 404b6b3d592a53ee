"""The port's pathline against mops_tpu at float64: the linear layer search,
the exact ztop clamp (also at float32), the attribute stack and
packed-table layout, the fused pathline step's
plain version against the Pallas kernel it replaces (interpret mode), and
the whole pathline run against ``mops_tpu.run_advection(..., back=...,
use_pallas=False)`` under x64.

Tolerances: the step is held to test_pallas.py's (positions 1e-6 m, hvel
1e-10 m/s, wvel 1e-12 m/s, ok equal) plus 1e-8 for attributes
(test_advect.py's pathline attribute tolerance; temperatures of ~20 carry
float64 summation-order noise near 1e-14).  The run is held to the
streamline slice's tolerances (test_torch_advect.py) and attributes to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu import advect as jadvect
from mops_tpu.pallas import pack_vertex_table as jax_pack
from mops_tpu.pallas.stage_kernel import \
    fused_pathline_step as jax_pathline_step
from mops_tpu_torch import advect
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax
from mops_tpu_torch.kernels.stage_kernel import (fused_pathline_step,
                                                 fused_pathline_step_plain,
                                                 pack_vertex_table)
from mops_tpu_torch.step import _clamp_profile, _layer_search_linear

torch.set_num_threads(1)

DT = 600.0
# (a1, a2, a4): mid-run, and near the end of the run where the clip at 1
# engages for a2 and a4 (dalpha = 0.01)
ALPHAS = {"mid": (0.3, 0.305, 0.31), "clip": (0.996, 1.0, 1.0)}


# --- layer search, attribute stack, table layout -----------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layer_search_linear_matches_jax(seed):
    """Random clamped profiles (with flat stretches, so that several
    intervals can hold a depth) and depths above, below, on interfaces and
    between layers."""
    rng = np.random.default_rng(seed)
    n, L = 400, 9
    z = -np.cumsum(rng.uniform(0.0, 50.0, (n, L)), axis=1)
    z[:, 3] = z[:, 2]                                    # a flat interval
    z = np.array(jadvect._clamp_profile(jnp.asarray(z), True))
    depth = rng.uniform(z[:, -1] - 30.0, z[:, 0] + 30.0)
    depth[:40] = z[:40, 4]                               # on interfaces
    depth[40:60] = z[40:60, 0] + 1.0                     # above
    depth[60:80] = z[60:80, -1] - 1.0                    # below
    layer, ok = _layer_search_linear(torch.from_numpy(z),
                                     torch.from_numpy(depth))
    ref_layer, ref_ok = jadvect._layer_search_linear(jnp.asarray(z),
                                                     jnp.asarray(depth))
    np.testing.assert_array_equal(layer.numpy(), np.asarray(ref_layer))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    assert ok.all()          # this profile family always holds the depth


def _clamp_case(case, dtype, L):
    """Raw ztop profiles of 300 lanes.  "raw": a third of them disturbed so
    that they ascend somewhere (Wachspress weights outside the cell can be
    negative); "monotone": none ascends; "rounds back": f32 profiles near
    -100 m, where z'[l-1] - 1e-9 rounds back to z'[l-1], so the clamp leaves
    flat steps."""
    rng = np.random.default_rng(L)
    z = -np.cumsum(rng.uniform(0.0, 80.0, (300, L)), axis=1)
    if case == "raw":
        z[::3] += rng.uniform(-120.0, 120.0, (100, L))
    elif case == "rounds back":
        z = -100.0 + rng.uniform(-1e-3, 1e-3, (300, L))
    return z.astype(dtype)


@pytest.mark.parametrize("case,dtype,L", [
    ("raw", "float32", 9), ("raw", "float32", 60), ("raw", "float32", 80),
    ("raw", "float64", 9), ("raw", "float64", 60), ("raw", "float64", 80),
    ("rounds back", "float32", 60), ("monotone", "float32", 60),
    ("monotone", "float64", 60)])
def test_clamp_profile_matches_jax(case, dtype, L):
    """The exact (sequential) clamp bit for bit against mops_tpu's, at the
    widths K2's grouped clamp meets; a profile with no ascending pair comes
    back unchanged (the premise of K2's fast path)."""
    z = _clamp_case(case, dtype, L)
    port = _clamp_profile(torch.from_numpy(z), True).numpy()
    ref = np.asarray(jadvect._clamp_profile(jnp.asarray(z), True))
    assert port.dtype == ref.dtype == z.dtype
    np.testing.assert_array_equal(port, ref)
    ascends = (z[:, 1:] > z[:, :-1]).any(axis=1)
    if case == "monotone":
        assert not ascends.any()
        np.testing.assert_array_equal(port, z)
    else:
        assert ascends.any() and (np.diff(port, axis=1) <= 0).all()
    if case == "rounds back":
        assert (np.diff(port, axis=1) == 0).any()


def test_layer_search_linear_not_found_fails():
    """A depth that falls in no interval (a gap wider than EPS_LAYER between
    a clamped step's top and the next bottom cannot happen on a monotone
    profile, so a NaN depth stands in) fails like mops_tpu's."""
    z = torch.tensor([[0.0, -10.0, -20.0], [0.0, -10.0, -20.0]])
    depth = torch.tensor([float("nan"), -5.0])
    layer, ok = _layer_search_linear(z, depth)
    ref_layer, ref_ok = jadvect._layer_search_linear(jnp.asarray(z.numpy()),
                                                     jnp.asarray(depth.numpy()))
    np.testing.assert_array_equal(layer.numpy(), np.asarray(ref_layer))
    np.testing.assert_array_equal(ok.numpy(), [False, True])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))


def test_stacked_vertex_attrs_order_matches_jax(sol):
    port = advect.stacked_vertex_attrs(solution_from_jax(sol))
    ref = jadvect.stacked_vertex_attrs(sol)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert advect.stacked_vertex_attrs(
        solution_from_jax(sol).to("cpu")).shape[-1] == 2
    no_attrs = mtt.SolutionFields(**{**solution_from_jax(sol).__dict__,
                                     "vertex_attrs": {}, "cell_attrs": {}})
    assert advect.stacked_vertex_attrs(no_attrs) is None


@pytest.mark.parametrize("n_attrs", [0, 1, 2])
def test_pack_vertex_table_with_attrs_matches_jax_layout(mesh, sol, n_attrs):
    stack = jadvect.stacked_vertex_attrs(sol)[..., :n_attrs] if n_attrs \
        else None
    ref = jax_pack(jnp.asarray(mesh.vertex_xyz), sol.vertex_ztop,
                   sol.vertex_velocity, sol.vertex_vert_velocity, stack)
    psol = solution_from_jax(sol)
    pstack = advect.stacked_vertex_attrs(psol)[..., :n_attrs] if n_attrs \
        else None
    port = pack_vertex_table(mesh_from_jax(mesh).vertex_xyz, psol.vertex_ztop,
                             psol.vertex_velocity, psol.vertex_vert_velocity,
                             pstack)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    L = psol.vertex_ztop.shape[1]
    assert port.shape[1] == mtt.kernels.stage_kernel.table_width(L, n_attrs)
    if n_attrs == 2:                      # attribute ai of layer l at A*l + ai
        o_a = 3 + 4 * L + L + 1
        np.testing.assert_array_equal(port[:, o_a + 2 * 3 + 1].numpy(),
                                      pstack[:, 3, 1].numpy())


# --- the fused pathline step ------------------------------------------------

@pytest.fixture(scope="module")
def sol_back_attrs(mesh, raw_fields):
    """A back snapshot whose velocities and attributes both differ from the
    front's, so that the alpha blend shows in every output."""
    raw = {k: np.asarray(v) * (1.2 if k.startswith("velocity") else
                               1.1 if k in ("temperature", "salinity") else 1.0)
           for k, v in raw_fields.items()}
    return mt.preprocess(mesh, raw)


def _case(mesh):
    """test_pallas.py's case (256 random seeds at 500 m) with edge lanes:
    out of cell, below the bottom, above the surface, dead (NaN), and on
    layer interfaces."""
    rng = np.random.default_rng(5)
    n = 256
    v = rng.normal(size=(n, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mt.EARTH_RADIUS
    cells = mt.CellSearch(mesh).query(seeds)
    depth_neg = np.full(n, -500.0)
    coc = np.asarray(mesh.cells_on_cell)
    cells[:16] = coc[cells[:16], 0]                      # out of cell
    depth_neg[16:32] = -4500.0                           # below the bottom
    depth_neg[32:40] = 5.0                               # above the surface
    seeds[40:44] = np.nan                                # dead lanes
    depth_neg[44:60] = np.linspace(-4000.0, 0.0, 16)     # on interfaces
    return seeds, cells.astype(np.int32), depth_neg


def _stacks(sol, n_attrs, torch_side):
    if not n_attrs:
        return None
    if torch_side:
        return advect.stacked_vertex_attrs(solution_from_jax(sol))[..., :n_attrs]
    return jadvect.stacked_vertex_attrs(sol)[..., :n_attrs]


def _jax_step(mesh, front, back, case, euler, n_attrs, alphas):
    seeds, cells, depth_neg = case
    vids, nv, _, _, _ = jadvect._gather_cell_vertices(mesh, jnp.asarray(cells))

    def cols(sol):
        tab = jax_pack(jnp.asarray(mesh.vertex_xyz), sol.vertex_ztop,
                       sol.vertex_velocity, sol.vertex_vert_velocity,
                       _stacks(sol, n_attrs, False))
        return jnp.moveaxis(tab[vids], 0, -1)            # (K, F, N)
    out = jax_pathline_step(
        jnp.asarray(seeds).T, jnp.asarray(depth_neg)[None],
        nv[None].astype(jnp.int32), cols(front), cols(back),
        front.vertex_ztop.shape[1], DT, alphas, euler=euler, n_attrs=n_attrs,
        block=256, interpret=True)
    new_pos, hvel, wvel, ok, attr = out
    return (np.asarray(new_pos).T, np.asarray(hvel).T, np.asarray(wvel)[0],
            np.asarray(ok)[0].astype(bool),
            None if attr is None else np.asarray(attr).T)


def _port_inputs(mesh, front, back, case, n_attrs):
    seeds, cells, depth_neg = case
    pmesh = mesh_from_jax(mesh)
    vids, nv, _ = advect._gather_cell_vertices(pmesh, torch.as_tensor(cells))

    def table(sol):
        psol = solution_from_jax(sol)
        return pack_vertex_table(pmesh.vertex_xyz, psol.vertex_ztop,
                                 psol.vertex_velocity,
                                 psol.vertex_vert_velocity,
                                 _stacks(sol, n_attrs, True))
    return (torch.as_tensor(seeds), torch.as_tensor(depth_neg), nv, vids,
            table(front), table(back), front.vertex_ztop.shape[1])


def _assert_step_close(port, ref):
    new_pos, hvel, wvel, ok = (t.numpy() for t in port[:4])
    np.testing.assert_allclose(new_pos, ref[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(hvel, ref[1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(wvel, ref[2], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ok, ref[3])
    if ref[4] is None:
        assert port[4] is None
    else:
        np.testing.assert_allclose(port[4].numpy(), ref[4], rtol=0, atol=1e-8)


@pytest.mark.parametrize("alphas", ["mid", "clip"])
@pytest.mark.parametrize("n_attrs", [0, 2])
@pytest.mark.parametrize("euler", [False, True], ids=["rk4", "euler"])
def test_plain_pathline_step_matches_jax_pallas_kernel(
        mesh, sol, sol_back_attrs, euler, n_attrs, alphas):
    case = _case(mesh)
    ref = _jax_step(mesh, sol, sol_back_attrs, case, euler, n_attrs,
                    ALPHAS[alphas])
    args = _port_inputs(mesh, sol, sol_back_attrs, case, n_attrs)
    got = fused_pathline_step_plain(*args, DT, ALPHAS[alphas], euler=euler,
                                    n_attrs=n_attrs)
    _assert_step_close(got, ref)
    ok = ref[3]
    assert not ok[:16].any() and not ok[40:44].any() and ok[16:40].all() \
        and ok[64:].any()
    if n_attrs:
        assert np.abs(ref[4][ok, :2]).min() > 0 and (ref[4][:, 2] == 0).all()


def test_pathline_wrapper_takes_the_plain_version_on_cpu(mesh, sol,
                                                         sol_back_attrs):
    args = _port_inputs(mesh, sol, sol_back_attrs, _case(mesh), 2)
    before = fused_pathline_step.launches
    got = fused_pathline_step(*args, DT, ALPHAS["mid"], n_attrs=2)
    want = fused_pathline_step_plain(*args, DT, ALPHAS["mid"], n_attrs=2)
    assert fused_pathline_step.launches == before        # no kernel launch
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_pathline_wrapper_rejects_what_the_kernel_does_not_take(
        mesh, sol, sol_back_attrs):
    pos, dn, nv, vids, tf, tb, L = _port_inputs(mesh, sol, sol_back_attrs,
                                                _case(mesh), 2)
    a = ALPHAS["mid"]
    with pytest.raises(ValueError):                     # table width vs A
        fused_pathline_step(pos, dn, nv, vids, tf, tb, L, DT, a, n_attrs=1)
    with pytest.raises(ValueError):                     # A above the ceiling
        fused_pathline_step(pos, dn, nv, vids, tf, tb, L, DT, a, n_attrs=3)
    with pytest.raises(ValueError):                     # the two tables differ
        fused_pathline_step(pos, dn, nv, vids, tf, tb[:, :-2].contiguous(),
                            L, DT, a, n_attrs=2)
    with pytest.raises(TypeError):
        fused_pathline_step(pos, dn, nv, vids, tf, tb.float(), L, DT, a,
                            n_attrs=2)
    with pytest.raises(TypeError):
        fused_pathline_step(pos, dn, nv, vids.long(), tf, tb, L, DT, a,
                            n_attrs=2)


# --- the pathline run ---------------------------------------------------------

def _attr_free(mesh, raw_fields, scale=1.0):
    """test_advect.py's attribute-free snapshot."""
    raw = {k: np.asarray(v) * (scale if k.startswith("velocity") else 1.0)
           for k, v in raw_fields.items()
           if k not in ("temperature", "salinity")}
    return mt.preprocess(mesh, raw)


@pytest.fixture(scope="module")
def snapshots(mesh, raw_fields, sol, sol_back):
    return {"attrs": (sol, sol_back),
            "no_attrs": (_attr_free(mesh, raw_fields),
                         _attr_free(mesh, raw_fields, scale=1.2))}


@pytest.fixture(scope="module")
def particles(mesh):
    """48 seeds over +-60 deg at depths 10..4500 m (the deepest below the
    4 km bottom), two of them dead (cell -1)."""
    rng = np.random.default_rng(11)
    n = 48
    lat = np.deg2rad(rng.uniform(-60, 60, n))
    lon = np.deg2rad(rng.uniform(-180, 180, n))
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(lat, lon))
    cells = mt.CellSearch(mesh).query(seeds)
    cells[[3, 30]] = -1
    depths = np.linspace(10.0, 4500.0, n).astype(np.float32)
    return seeds, cells, depths


def _settings(mod, method, direction, fail_mode, depths):
    return mod.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=depths, method=getattr(mod.CalcMethod, method),
        direction=getattr(mod.CalcDirection, direction),
        fail_mode=getattr(mod.FailMode, fail_mode))


@pytest.mark.parametrize("attrs", ["attrs", "no_attrs"])
@pytest.mark.parametrize("fail_mode", ["FREEZE", "ZERO"])
@pytest.mark.parametrize("direction", ["FORWARD", "BACKWARD"])
@pytest.mark.parametrize("method", ["RK4", "EULER"])
def test_pathline_slice_matches_jax_oracle(mesh, snapshots, particles, method,
                                           direction, fail_mode, attrs):
    front, back = snapshots[attrs]
    seeds, cells, depths = particles
    ref_cfg = _settings(mt, method, direction, fail_mode, depths)
    ref = mt.run_advection(mesh, front, seeds, cells, ref_cfg, back=back,
                           use_pallas=False)
    cfg = _settings(mtt, method, direction, fail_mode, depths)
    pmesh = mesh_from_jax(mesh)
    pf, pb = solution_from_jax(front), solution_from_jax(back)
    c = lambda t: t.cpu().numpy()
    for use_kernel in (True, False):
        port = mtt.run_advection(pmesh, pf, seeds, cells, cfg, back=pb,
                                 use_kernel=use_kernel, device="cpu")
        np.testing.assert_allclose(c(port.points), np.asarray(ref.points),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(c(port.velocities),
                                   np.asarray(ref.velocities), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(c(port.attrs), np.asarray(ref.attrs),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(c(port.final_position),
                                   np.asarray(ref.final_position), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(c(port.final_depth),
                                   np.asarray(ref.final_depth), rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(c(port.final_cell),
                                      np.asarray(ref.final_cell))
        np.testing.assert_array_equal(c(port.alive), np.asarray(ref.alive))
    has_attrs = bool(np.abs(np.asarray(ref.attrs)).sum() > 0)
    assert has_attrs == (attrs == "attrs")
    lines = mtt.finalize_trajectories(
        seeds, c(port.points), c(port.velocities), cfg, attrs=c(port.attrs),
        with_attrs=True)
    ref_lines = mt.finalize_trajectories(
        seeds, np.asarray(ref.points), np.asarray(ref.velocities), ref_cfg,
        attrs=np.asarray(ref.attrs), with_attrs=True)
    assert len(lines) == len(ref_lines) == len(seeds)
    for a, b in zip(lines, ref_lines):
        np.testing.assert_allclose(a.points, b.points, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.attrs, b.attrs, rtol=0, atol=1e-8)
        # the reference's WithAttrs copy puts velocity x/y there
        np.testing.assert_allclose(a.temperature, b.temperature, rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(a.salinity, b.salinity, rtol=0, atol=1e-10)
