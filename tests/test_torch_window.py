"""The port's layer-window steps (K3, K4) against mops_tpu at float64: their
plain versions against the Pallas window kernels they replace (interpret
mode) on every lane the window serves, the full-column step on the lanes it
misses, and windowed runs against the JAX float64 oracle,
``mops_tpu.run_advection(..., use_pallas=False)``.

The conftest mesh has L = 6, so the tests use windows of W = 4 layers
(starts 0..2), where the window edges fall inside the column.

Tolerances are test_pallas.py's (positions 1e-6 m, hvel 1e-10 m/s, wvel
1e-12 m/s, ok equal) plus 1e-8 for attributes (test_advect.py's pathline
attribute tolerance); layer and edge-miss flags are equal.  The runs are
held to the slice tests' tolerances (test_torch_advect.py).

Where raw ztop columns rise, the port parts from mops_tpu's window kernel:
it flags a clamp miss wherever the window's clamp or its surface and bottom
tests may depart from the full column's (step.py, "the layer-window step"),
and those lanes take the full step, the reference mops_tpu's full-column
kernel and its oracle compute.  The last tests hold the window steps on
rising columns to the port's full step and to mops_tpu's oracle, float32
at chip_smoke.py's kernel-check tolerances (2 m, 1e-4 of the largest
velocity or attribute, at most one lane flipping ok).
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
from mops_tpu_torch.step import (cell_rise, start_layer, window_cols,
                                 window_pathline_step, window_starts,
                                 window_streamline_step)

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
    """The port's window step on the case: (new_pos, hvel, wvel, ok, layer,
    miss, clamp, attr or None), the full step (new_pos, hvel, wvel, ok,
    attr or None) and the inputs."""
    seeds, cells, depth_neg, s = case
    pmesh = mesh_from_jax(mesh)
    vids, nv, _ = advect._gather_cell_vertices(pmesh, torch.as_tensor(cells))
    tabs = [_table(pmesh, solution_from_jax(sol), n_attrs,
                   _stack(sol, n_attrs, True)) for sol in sols]
    pos, dn = torch.as_tensor(seeds), torch.as_tensor(depth_neg)
    L = sols[0].vertex_ztop.shape[1]
    rises = [sk.table_rise(t, L) for t in tabs]
    if len(sols) == 1:
        fn = sk.fused_window_streamline_step_plain if plain \
            else sk.fused_window_streamline_step
        full = sk.fused_streamline_step_plain(pos, dn, nv, vids, tabs[0], L,
                                              DT, euler)
        return (*fn(pos, dn, nv, vids, s, tabs[0], rises[0], L, W, DT,
                    euler), None), \
            (*full, None), (pos, dn, nv, vids, tabs)
    fn = sk.fused_window_pathline_step_plain if plain \
        else sk.fused_window_pathline_step
    full = sk.fused_pathline_step_plain(pos, dn, nv, vids, tabs[0], tabs[1], L,
                                        DT, ALPHAS, euler, n_attrs)
    return fn(pos, dn, nv, vids, s, tabs[0], tabs[1], *rises, L, W, DT,
              ALPHAS, euler, n_attrs), full, (pos, dn, nv, vids, tabs)


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
    """The port's edge misses equal mops_tpu's misses everywhere.  Lanes
    the window serves: every output equals mops_tpu's window kernel.  Lanes
    it misses (mops_tpu's step loop recomputes its misses on the full
    column; the port also recomputes the lanes that only its clamp test
    flags): the full-column step, bit for bit on clamp-only lanes, and the
    start position's layer."""
    n_attrs = int(path[-1]) if path != "streamline" else 0
    sols = [sol] if path == "streamline" else [sol, sol_back_attrs]
    case = _case(mesh, sol)
    ref = _jax_window(mesh, sols, case, euler, n_attrs)
    got, full, (pos, dn, nv, vids, tabs) = _port(mesh, sols, case, euler,
                                                 n_attrs)
    miss, clamp = got[5].numpy(), got[6].numpy()
    assert not (clamp & ~miss).any()
    np.testing.assert_array_equal(miss & ~clamp, ref[5])
    assert 0 < miss.sum() < len(miss) // 2
    hit = ~miss
    _close(got, ref, hit)
    np.testing.assert_array_equal(got[4].numpy()[hit], ref[4][hit])
    if n_attrs:
        np.testing.assert_allclose(got[7].numpy()[hit], ref[6][hit], rtol=0,
                                   atol=1e-8)
    else:
        assert got[7] is None and ref[6] is None
    _close(got, tuple(t.numpy() for t in full[:4]), miss)
    for g, f in zip(got[:4], full[:4]):
        np.testing.assert_array_equal(g.numpy()[clamp], f.numpy()[clamp])
    if n_attrs:
        np.testing.assert_array_equal(got[7].numpy()[miss],
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
        before = sk.launch_counts()
        got, _, _ = _port(mesh, sols, case, False, n_attrs, plain=False)
        want, _, _ = _port(mesh, sols, case, False, n_attrs)
        assert sk.launch_counts() == before              # no kernel launch
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
    rise = sk.table_rise(tab, 6)
    step = sk.fused_window_streamline_step
    with pytest.raises(ValueError):                       # int64 starts
        step(pos, dn, nv, vids, s.long(), tab, rise, 6, W, DT)
    with pytest.raises(ValueError):                       # starts per lane
        step(pos, dn, nv, vids, s[:-1].contiguous(), tab, rise, 6, W, DT)
    for bad_w in (1, 7, sk.W_MAX + 1):                    # 2 <= W <= L
        with pytest.raises(ValueError):
            step(pos, dn, nv, vids, s, tab, rise, 6, bad_w, DT)
    for bad_rise in (rise.long(), rise[:-1].contiguous()):  # (nV,) int32
        with pytest.raises(ValueError):
            step(pos, dn, nv, vids, s, tab, bad_rise, 6, W, DT)
    with pytest.raises(ValueError):                       # A above the ceiling
        sk.fused_window_pathline_step(pos, dn, nv, vids, s, tab, tab, rise,
                                      rise, 6, W, DT, ALPHAS, n_attrs=3)


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
                                         path, method, monkeypatch):
    """A run through the layer-window step with windows of W = 4 equals
    the exact JAX path, attributes included, and counts its misses."""
    seeds, cells, depths = particles
    back = sol_back_attrs if path == "pathline" else None
    monkeypatch.setattr(advect, "WINDOW_LAYERS", W)
    ref = mt.run_advection(mesh, sol, seeds, cells,
                           _settings(mt, method, depths), back=back,
                           use_pallas=False)
    port = mtt.run_advection(
        mesh_from_jax(mesh), solution_from_jax(sol), seeds, cells,
        _settings(mtt, method, depths), device="cpu", use_window=True,
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


# --- rising columns: the clamp miss ------------------------------------------

LR = 12                  # layers of the rising-column case (windows of W)
VERTEX_LANE = 5          # a lane on a vertex of its cell: NaN weights


def test_first_rise_and_cell_rise():
    """first_rise against a loop over layers; cell_rise the least over
    each cell's nv vertices only."""
    from mops_tpu_torch.step import cell_rise, first_rise
    rng = np.random.default_rng(3)
    z = -np.cumsum(rng.uniform(1.0, 10.0, (40, 9)), axis=1)
    up = rng.random(z.shape) < 0.08
    z[up] += 50.0
    want = np.full(40, 9)
    for v in range(40):
        for l in range(1, 9):
            if z[v, l] > z[v, l - 1]:
                want[v] = l
                break
    got = first_rise(torch.as_tensor(z))
    assert got.dtype == torch.int32 and 0 < (want < 9).sum() < 40
    np.testing.assert_array_equal(got.numpy(), want)
    vids = torch.as_tensor(rng.integers(0, 40, (30, 6)), dtype=torch.int32)
    nv = torch.as_tensor(rng.integers(3, 7, 30), dtype=torch.int32)
    cr = cell_rise(got, vids, nv).numpy()
    for i in range(30):
        assert cr[i] == want[vids[i, :nv[i]].numpy()].min()


def _rise(ztop, rng, share=0.2, per_layer=400.0):
    """ztop (nV, L) with the columns of ``share`` of the vertices turned
    upward from a layer a in 1..L-4: per_layer metres a layer above the
    value at a-1 (a lane whose weight on such a vertex is above about
    0.45 sees its profile rise)."""
    z = np.array(ztop, dtype=np.float64)
    n, L = z.shape
    bad = rng.choice(n, int(share * n), replace=False)
    a = rng.integers(1, L - 3, len(bad))
    lg = np.arange(L)
    lift = np.where(lg[None, :] >= a[:, None],
                    z[bad, a - 1][:, None]
                    + per_layer * (lg[None, :] - a[:, None] + 1) - z[bad], 0.0)
    z[bad] += lift
    return z


@pytest.fixture(scope="module")
def rising_case():
    """A 400-cell L12 mesh with two snapshots (numpy-seeded) in two forms:
    "monotone" as synthesised and "rising" (_rise on each snapshot, the
    back one from other layers); 256 seeds at 10..3,900 m, lane
    VERTEX_LANE on a vertex of its cell.  Returns (mesh, {form: (front,
    back)}, seeds, cells, depths)."""
    import dataclasses
    mesh = mt.synth.build_voronoi_mesh(400, jitter=0.05, n_layers=LR)
    kw = dict(n_layers=LR, w_scale=1e-4, bathymetry_amp=0.5)
    front, back = (mt.preprocess(mesh, mt.synth.solid_body_fields(
        mesh, omega=om, **kw)) for om in (1e-5, 1.2e-5))
    rng = np.random.default_rng(12)
    rising = tuple(dataclasses.replace(sol, vertex_ztop=jnp.asarray(
        _rise(sol.vertex_ztop, rng))) for sol in (front, back))
    v = rng.normal(size=(256, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mt.EARTH_RADIUS
    cells = mt.CellSearch(mesh).query(seeds).astype(np.int32)
    vid = int(np.asarray(mesh.vertices_on_cell)[cells[VERTEX_LANE], 0])
    seeds[VERTEX_LANE] = np.asarray(mesh.vertex_xyz)[vid]
    depths = np.linspace(10.0, 3900.0, 256).astype(np.float32)
    return mesh, {"monotone": (front, back), "rising": rising}, seeds, \
        cells, depths


def _rising_inputs(case, form, pathline, real):
    """The port's step inputs at ``real``: (pos, dn, nv, vids, tables,
    rises, s), windows of W around each lane's start layer, at the
    column's far end on every fourth lane, and at 2 on VERTEX_LANE."""
    mesh, forms, seeds, cells, depths = case
    pm = mesh_from_jax(mesh).to("cpu", real)
    sols = [solution_from_jax(s).to("cpu", real)
            for s in forms[form][:2 if pathline else 1]]
    table, table_b, n_attrs = advect.snapshot_tables(pm, *sols)
    tabs = [table] + ([table_b] if pathline else [])
    assert n_attrs == (2 if pathline else 0)
    vids, nv, _ = advect._gather_cell_vertices(pm, torch.as_tensor(cells))
    pos = torch.as_tensor(seeds).to(real)
    dn = -torch.as_tensor(depths).to(real)
    vpos, cols = sk._split_rows(table, vids, LR, n_attrs)
    s = window_starts(start_layer(cols[0], pos, dn, nv, vpos, pathline),
                      LR, W)
    far = torch.where(s < (LR - W + 1) // 2, LR - W, 0).to(torch.int32)
    s = torch.where(torch.arange(len(s)) % 4 == 3, far, s)
    s[VERTEX_LANE] = 2
    return (pos, dn, nv, vids, tabs, [sk.table_rise(t, LR) for t in tabs],
            s.contiguous(), n_attrs)


def _windows(cols, s):
    return tuple(window_cols(c, s, W) for c in cols)


@pytest.fixture(scope="module")
def rising_oracle(rising_case):
    """mops_tpu's oracle, run_advection(..., use_pallas=False), one step
    from the seeds, by (form, pathline, method, dtype); computed on first
    use."""
    mesh, forms, seeds, cells, depths = rising_case
    cache = {}

    def get(form, pathline, method, real):
        key = form, pathline, method, real
        if key not in cache:
            front, back = forms[form]
            cfg = mt.TrajectorySettings(
                delta_t=DT, simulation_duration=DT, record_t=DT,
                particle_depths=depths, fail_mode=mt.FailMode.ZERO,
                method=getattr(mt.CalcMethod, method))
            cache[key] = mt.run_advection(mesh, front, seeds, cells, cfg,
                                          back=back if pathline else None,
                                          dtype=real, use_pallas=False)
        return cache[key]
    return get


@pytest.mark.parametrize("form", ["rising", "monotone"])
@pytest.mark.parametrize("method", ["RK4", "EULER"])
@pytest.mark.parametrize("real", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["k3", "k4"])
def test_window_step_on_rising_columns_is_the_full_step(
        rising_case, rising_oracle, kernel, real, method, form, monkeypatch):
    """K3's and K4's plain versions where raw ztop columns rise above,
    inside and below the window: every lane's ok equals the full step's,
    the clamp-flagged lanes' outputs are the full step's bit for bit, the
    others within tolerance.  On rising columns the clamp test flags
    lanes, and on some of them the window alone would have parted from
    the full step (the fault it repairs); on monotone columns it flags
    none but the vertex lane (its weights are NaN).  A one-step run
    through the window path is held to mops_tpu's oracle at the same
    dtype (at float32 the oracle's own float32 path: its one step parts
    from the float64 one by up to 19 m on these columns, the port's
    full-column and window paths alike)."""
    pathline = kernel == "k4"
    euler = method == "EULER"
    pos, dn, nv, vids, tabs, rises, s, n_attrs = _rising_inputs(
        rising_case, form, pathline, real)
    if pathline:
        win = sk.fused_window_pathline_step_plain(
            pos, dn, nv, vids, s, *tabs, *rises, LR, W, DT, ALPHAS, euler,
            n_attrs)
        full = sk.fused_pathline_step_plain(pos, dn, nv, vids, *tabs, LR, DT,
                                            ALPHAS, euler, n_attrs)
        pairs = [(win[i], full[i]) for i in range(4)] + [(win[7], full[4])]
    else:
        win = sk.fused_window_streamline_step_plain(
            pos, dn, nv, vids, s, tabs[0], rises[0], LR, W, DT, euler)
        full = sk.fused_streamline_step_plain(pos, dn, nv, vids, tabs[0], LR,
                                              DT, euler)
        pairs = [(win[i], full[i]) for i in range(4)]
    miss, clamp = win[5], win[6]
    assert not bool((clamp & ~miss).any())
    assert torch.equal(win[3], full[3])                 # ok on every lane
    for a, b in pairs:
        assert torch.equal(a[clamp].nan_to_num(1.5), b[clamp].nan_to_num(1.5))
    f64 = real == torch.float64
    for i, (a, b) in enumerate(pairs[:3] + pairs[4:]):
        assert torch.equal(a.isnan(), b.isnan())    # Euler's NaN, both
        tol = ((1e-6, 1e-10, 1e-12, 1e-8)[i] if f64 else
               2.0 if i == 0 else 1e-4 * float(b.abs().nan_to_num(0).max()))
        assert float((a - b).abs().nan_to_num(0).max()) <= tol
    assert bool(clamp[VERTEX_LANE]) and not bool(win[3][VERTEX_LANE])
    flagged = clamp.clone()
    flagged[VERTEX_LANE] = False
    if form == "monotone":
        assert not bool(flagged.any())                  # no new miss
    else:
        assert int(flagged.sum()) >= 4
        # the window step alone on those lanes (the parent's): some part
        # from the full step
        vpos, cols = sk._split_rows(tabs[0], vids, LR, n_attrs)
        ends = (cols[0][..., 0], cols[0][..., -1])
        rmin = [cell_rise(r, vids, nv) for r in rises]
        if pathline:
            _, cols_b = sk._split_rows(tabs[1], vids, LR, n_attrs)
            a = tuple(torch.as_tensor(x, dtype=real) for x in ALPHAS)
            alone = window_pathline_step(
                _windows(cols, s), _windows(cols_b, s), ends, s,
                LR, pos, dn, nv, vpos, DT, a, euler, rmin, n_attrs)
        else:
            alone = window_streamline_step(
                _windows(cols, s), ends, s, LR, pos, dn, nv, vpos, DT,
                euler, rmin[0])
        parted = flagged & ((alone[3] != full[3]) | (
            (alone[0] - full[0]).norm(dim=1).nan_to_num(0) > 2.0))
        assert bool(parted.any())
    # one step through the window path against mops_tpu's oracle
    mesh, forms, seeds, cells, depths = rising_case
    front, back = forms[form]
    cfg = mtt.TrajectorySettings(
        delta_t=DT, simulation_duration=DT, record_t=DT,
        particle_depths=depths, fail_mode=mtt.FailMode.ZERO,
        method=getattr(mtt.CalcMethod, method))
    monkeypatch.setattr(advect, "WINDOW_LAYERS", W)
    got = mtt.run_advection(
        mesh_from_jax(mesh), solution_from_jax(front), seeds, cells, cfg,
        back=solution_from_jax(back) if pathline else None, dtype=real,
        device="cpu", use_window=True)
    assert advect.LAST_RESOLVED["kernel"] == kernel
    ref = rising_oracle(form, pathline, method,
                        jnp.float64 if f64 else jnp.float32)
    pts, vel = got.points.double().numpy(), got.velocities.double().numpy()
    rp, rv = np.asarray(ref.points), np.asarray(ref.velocities)
    if f64:
        np.testing.assert_allclose(pts, rp, rtol=0, atol=1e-6)
        np.testing.assert_allclose(vel, rv, rtol=0, atol=1e-10)
        np.testing.assert_array_equal(got.alive.numpy(),
                                      np.asarray(ref.alive))
    else:
        same = got.alive.numpy() == np.asarray(ref.alive)
        assert int((~same).sum()) <= 1
        for a, b, tol in ((pts, rp, 2.0),
                          (vel, rv, 1e-4 * np.nanmax(np.abs(rv)))):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            assert np.nan_to_num(np.abs(a - b))[same].max() <= tol
    if form == "rising":
        assert int(got.window_clamp_misses.sum()) > 0
