"""The port's layer-window steps (K3, K4) against mops_tpu at float64: their
plain versions against the Pallas window kernels they replace (interpret
mode) on every lane the window serves, the full-column step on the lanes it
misses, and windowed runs against the JAX float64 oracle,
``mops_tpu.run_advection(..., use_pallas=False)``.

The conftest mesh has L = 6, so the tests use windows of W = 4 layers
(starts 0..2), where the window edges fall inside the column.

Tolerances are test_pallas.py's (positions 1e-6 m, hvel 1e-10 m/s, wvel
1e-12 m/s, ok equal) plus 1e-8 for attributes (test_advect.py's pathline
attribute tolerance); layer and miss flags are equal.  The runs are held
to the slice tests' tolerances (test_torch_advect.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu import advect as jadvect
from mops_tpu.pallas import window_kernel as jwk
from mops_tpu_torch import advect
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax
from mops_tpu_torch.kernels import stage_kernel as sk
from mops_tpu_torch.step import start_layer, window_starts

torch.set_num_threads(1)

DT = 600.0
W = 4
ALPHAS = (0.3, 0.305, 0.31)


@pytest.fixture(scope="module")
def sol_back_attrs(mesh, raw_fields):
    """A back snapshot whose velocities and attributes both differ."""
    raw = {k: np.asarray(v) * (1.2 if k.startswith("velocity") else
                               1.1 if k in ("temperature", "salinity") else 1.0)
           for k, v in raw_fields.items()}
    return mt.preprocess(mesh, raw)


def _case(mesh, sol):
    """test_pallas.py's 256 random seeds with depths spread over the column
    and the edge lanes (out of cell, below the bottom, above the surface,
    dead); window starts placed around each seed's layer as run_advection
    places them, then shifted by one or two layers on some lanes so that
    their depth leaves the window (misses)."""
    rng = np.random.default_rng(7)
    n = 256
    v = rng.normal(size=(n, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mt.EARTH_RADIUS
    cells = mt.CellSearch(mesh).query(seeds).astype(np.int32)
    depth_neg = -rng.uniform(10.0, 3900.0, n)
    coc = np.asarray(mesh.cells_on_cell)
    cells[:16] = coc[cells[:16], 0]                      # out of cell
    depth_neg[16:32] = -4500.0                           # below the bottom
    depth_neg[32:40] = 5.0                               # above the surface
    seeds[40:44] = np.nan                                # dead lanes
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    vids, nv, _ = advect._gather_cell_vertices(pmesh, torch.as_tensor(cells))
    vpos, cols = sk._split_rows(_table(pmesh, psol, 0), vids, 6, 0)
    layer = start_layer(cols[0], torch.as_tensor(seeds),
                        torch.as_tensor(depth_neg), nv, vpos, False)
    s = window_starts(layer, 6, W)
    shift = np.zeros(n, dtype=np.int32)
    shift[60:100:2], shift[61:100:2] = 2, -2
    s = torch.clamp(s + torch.as_tensor(shift), 0, 6 - W).to(torch.int32)
    return seeds, cells, depth_neg, s.contiguous()


def _stack(sol, n_attrs, torch_side):
    if not n_attrs:
        return None
    if torch_side:
        return advect.stacked_vertex_attrs(solution_from_jax(sol))[..., :n_attrs]
    return jadvect.stacked_vertex_attrs(sol)[..., :n_attrs]


def _table(pmesh, psol, n_attrs, stack=None):
    return sk.pack_vertex_table(pmesh.vertex_xyz, psol.vertex_ztop,
                                psol.vertex_velocity,
                                psol.vertex_vert_velocity, stack)


def _jax_window(mesh, sols, case, euler, n_attrs):
    """mops_tpu's window kernel on the same lanes: window and static rows
    from build_window_tables (the front snapshot's statics), gathered at
    each lane's (cell, start)."""
    seeds, cells, depth_neg, s = case
    vids, nv, _, _, _ = jadvect._gather_cell_vertices(mesh, jnp.asarray(cells))
    wins, kstatic = [], None
    for sol in sols:
        tab, kst, C = jwk.build_window_tables(
            mesh.vertices_on_cell, mesh.vertex_xyz, sol.vertex_ztop,
            sol.vertex_velocity, sol.vertex_vert_velocity,
            _stack(sol, n_attrs, False))
        kstatic = kst if kstatic is None else kstatic
        KC = tab.shape[1] // sol.vertex_ztop.shape[1]
        wins.append(jwk.window_gather(tab, jnp.asarray(cells),
                                      jnp.asarray(s.numpy()), W, KC))
    kstat = kstatic[jnp.asarray(cells)].T
    args = (jnp.asarray(seeds).T, jnp.asarray(depth_neg)[None],
            nv[None].astype(jnp.int32), jnp.asarray(s.numpy())[None], kstat)
    L = sols[0].vertex_ztop.shape[1]
    if len(sols) == 1:
        out = jwk.fused_window_streamline_step(*args, wins[0], L, DT,
                                               euler=euler, block=256,
                                               interpret=True)
        out = (*out, None)
    else:
        out = jwk.fused_window_pathline_step(
            *args, wins[0], wins[1], L, DT, ALPHAS, euler=euler,
            n_attrs=n_attrs, block=256, interpret=True)
    new_pos, hvel, wvel, ok, layer, miss, attr = out
    return (np.asarray(new_pos).T, np.asarray(hvel).T, np.asarray(wvel)[0],
            np.asarray(ok)[0].astype(bool), np.asarray(layer)[0],
            np.asarray(miss)[0].astype(bool),
            None if attr is None else np.asarray(attr).T)


def _port(mesh, sols, case, euler, n_attrs, plain=True):
    seeds, cells, depth_neg, s = case
    pmesh = mesh_from_jax(mesh)
    vids, nv, _ = advect._gather_cell_vertices(pmesh, torch.as_tensor(cells))
    tabs = [_table(pmesh, solution_from_jax(sol), n_attrs,
                   _stack(sol, n_attrs, True)) for sol in sols]
    pos, dn = torch.as_tensor(seeds), torch.as_tensor(depth_neg)
    L = sols[0].vertex_ztop.shape[1]
    if len(sols) == 1:
        fn = sk.fused_window_streamline_step_plain if plain \
            else sk.fused_window_streamline_step
        full = sk.fused_streamline_step_plain(pos, dn, nv, vids, tabs[0], L,
                                              DT, euler)
        return (*fn(pos, dn, nv, vids, s, tabs[0], L, W, DT, euler), None), \
            (*full, None), (pos, dn, nv, vids, tabs)
    fn = sk.fused_window_pathline_step_plain if plain \
        else sk.fused_window_pathline_step
    full = sk.fused_pathline_step_plain(pos, dn, nv, vids, tabs[0], tabs[1], L,
                                        DT, ALPHAS, euler, n_attrs)
    return fn(pos, dn, nv, vids, s, tabs[0], tabs[1], L, W, DT, ALPHAS, euler,
              n_attrs), full, (pos, dn, nv, vids, tabs)


def _close(got, want, lanes):
    """got (torch) vs want (numpy) on the boolean lane mask."""
    tol = (1e-6, 1e-10, 1e-12)
    for g, w, t in zip(got[:3], want[:3], tol):
        np.testing.assert_allclose(g.numpy()[lanes], w[lanes], rtol=0, atol=t)
    np.testing.assert_array_equal(got[3].numpy()[lanes], want[3][lanes])


@pytest.mark.parametrize("path", ["streamline", "pathline_0", "pathline_2"])
@pytest.mark.parametrize("euler", [False, True], ids=["rk4", "euler"])
def test_plain_window_step_matches_jax_window_kernel(mesh, sol, sol_back_attrs,
                                                     path, euler):
    """Lanes the window serves: every output equals mops_tpu's window
    kernel.  Miss flags equal everywhere.  Lanes it misses (mops_tpu's
    step loop recomputes those on the full column): the full-column step and
    the start position's layer."""
    n_attrs = int(path[-1]) if path != "streamline" else 0
    sols = [sol] if path == "streamline" else [sol, sol_back_attrs]
    case = _case(mesh, sol)
    ref = _jax_window(mesh, sols, case, euler, n_attrs)
    got, full, (pos, dn, nv, vids, tabs) = _port(mesh, sols, case, euler,
                                                 n_attrs)
    miss = got[5].numpy()
    np.testing.assert_array_equal(miss, ref[5])
    assert 0 < miss.sum() < len(miss) // 2
    hit = ~miss
    _close(got, ref, hit)
    np.testing.assert_array_equal(got[4].numpy()[hit], ref[4][hit])
    if n_attrs:
        np.testing.assert_allclose(got[6].numpy()[hit], ref[6][hit], rtol=0,
                                   atol=1e-8)
    else:
        assert got[6] is None and ref[6] is None
    _close(got, tuple(t.numpy() for t in full[:4]), miss)
    if n_attrs:
        np.testing.assert_array_equal(got[6].numpy()[miss],
                                      full[4].numpy()[miss])
    vpos, cols = sk._split_rows(tabs[0], vids, 6, n_attrs)
    layer = start_layer(cols[0], pos, dn, nv, vpos, path != "streamline")
    np.testing.assert_array_equal(got[4].numpy()[miss], layer.numpy()[miss])
    ok = ref[3]
    assert not ok[:16].any() and not ok[40:44].any() and ok[64:].any()


def test_window_wrappers_take_the_plain_versions_on_cpu(mesh, sol,
                                                        sol_back_attrs):
    case = _case(mesh, sol)
    for sols, n_attrs in (([sol], 0), ([sol, sol_back_attrs], 2)):
        fn = sk.fused_window_streamline_step if len(sols) == 1 \
            else sk.fused_window_pathline_step
        before = fn.launches
        got, _, _ = _port(mesh, sols, case, False, n_attrs, plain=False)
        want, _, _ = _port(mesh, sols, case, False, n_attrs)
        assert fn.launches == before                     # no kernel launch
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=0,
                                           equal_nan=True)


def test_window_wrappers_reject_what_the_kernels_do_not_take(mesh, sol):
    seeds, cells, depth_neg, s = _case(mesh, sol)
    pmesh, psol = mesh_from_jax(mesh), solution_from_jax(sol)
    vids, nv, _ = advect._gather_cell_vertices(pmesh, torch.as_tensor(cells))
    tab = _table(pmesh, psol, 0)
    pos, dn = torch.as_tensor(seeds), torch.as_tensor(depth_neg)
    step = sk.fused_window_streamline_step
    with pytest.raises(ValueError):                       # int64 starts
        step(pos, dn, nv, vids, s.long(), tab, 6, W, DT)
    with pytest.raises(ValueError):                       # starts per lane
        step(pos, dn, nv, vids, s[:-1].contiguous(), tab, 6, W, DT)
    for bad_w in (1, 7, sk.W_MAX + 1):                    # 2 <= W <= L
        with pytest.raises(ValueError):
            step(pos, dn, nv, vids, s, tab, 6, bad_w, DT)
    with pytest.raises(ValueError):                       # A above the ceiling
        sk.fused_window_pathline_step(pos, dn, nv, vids, s, tab, tab, 6, W,
                                      DT, ALPHAS, n_attrs=3)


def test_window_starts_match_jax():
    layer = np.arange(1, 60, dtype=np.int32)
    for L, w in ((60, 8), (6, 4), (8, 8)):
        lay = np.clip(layer, 1, L - 1)
        np.testing.assert_array_equal(
            window_starts(torch.as_tensor(lay), L, w).numpy(),
            np.asarray(jwk.window_starts(jnp.asarray(lay), L, w)))


# --- windowed runs against the JAX oracle ----------------------------------

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


def _settings(mod, method, depths):
    return mod.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=depths, method=getattr(mod.CalcMethod, method),
        fail_mode=mod.FailMode.ZERO)


@pytest.mark.parametrize("path", ["streamline", "pathline"])
@pytest.mark.parametrize("method", ["RK4", "EULER"])
def test_windowed_run_matches_jax_oracle(mesh, sol, sol_back_attrs, particles,
                                         path, method):
    """A run through the layer-window step with windows of W = 4 equals
    the exact JAX path, attributes included, and counts its misses."""
    seeds, cells, depths = particles
    back = sol_back_attrs if path == "pathline" else None
    ref = mt.run_advection(mesh, sol, seeds, cells,
                           _settings(mt, method, depths), back=back,
                           use_pallas=False)
    port = mtt.run_advection(
        mesh_from_jax(mesh), solution_from_jax(sol), seeds, cells,
        _settings(mtt, method, depths), device="cpu", use_window=True,
        window=W,
        back=None if back is None else solution_from_jax(back))
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
    if back is not None:
        np.testing.assert_allclose(c(port.attrs), np.asarray(ref.attrs),
                                   rtol=0, atol=1e-8)
    assert port.window_misses is not None
    assert port.window_misses.shape == (len(seeds),)
    assert int(port.window_misses.min()) >= 0
