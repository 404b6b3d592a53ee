"""The CUDA kernels against their plain PyTorch versions, on a card: the
fused step kernels (K1 streamline, K2 pathline, their layer-window forms K3
and K4 with the masked K1/K2 repair of their miss lanes, and K3 against K1
bit for bit) and the row-gather probe K5.

Imports no jax, so it runs where only torch is installed; the repo's
conftest imports jax, so run it on the card with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card every test skips.  Float64 tolerances are test_pallas.py's:
positions 1e-6 m, hvel 1e-10 m/s, wvel 1e-12 m/s, ok equal; attributes
1e-8 (test_advect.py's pathline attribute tolerance).  K5: heads
bit-equal, block sums within 1e-12 of the sum of the block's magnitudes
(the same values added in other orders).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import mops_tpu_torch as mtt
from mops_tpu_torch import advect
from mops_tpu_torch.interp import wachspress_weights
from mops_tpu_torch.kernels import row_gather as rg
from mops_tpu_torch.kernels import stage_kernel as sk
from mops_tpu_torch.kernels.stage_kernel import (fused_pathline_step,
                                                 fused_pathline_step_plain,
                                                 fused_streamline_step,
                                                 fused_streamline_step_plain,
                                                 pack_vertex_table)
from mops_tpu_torch.step import start_layer, window_starts

DT = 600.0


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernel has no CPU mode")
    mesh = mtt.synth.build_voronoi_mesh(500, n_layers=6)
    raw = mtt.synth.solid_body_fields(mesh, n_layers=6, w_scale=1e-4)
    dev = torch.device("cuda")
    mesh = mesh.to(dev, torch.float64)
    return mesh, mtt.preprocess(mesh, raw), dev


@pytest.fixture(scope="module")
def card_back(card):
    """A second snapshot with faster velocities and warmer, saltier water."""
    mesh, _, _ = card
    raw = mtt.synth.solid_body_fields(mesh, n_layers=6, w_scale=1e-4,
                                      omega=1.2e-5)
    raw = {k: v * 1.1 if k in ("temperature", "salinity") else v
           for k, v in raw.items()}
    return mtt.preprocess(mesh, raw)


def _step_inputs(mesh, sol, dev):
    rng = np.random.default_rng(5)
    n = 256
    v = rng.normal(size=(n, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mtt.EARTH_RADIUS
    cells = mtt.CellSearch(mesh).query(seeds)
    coc = mesh.cells_on_cell.cpu().numpy()
    cells[:16] = coc[cells[:16], 0]                      # out of cell
    depth_neg = np.full(n, -500.0)
    depth_neg[16:32] = -4500.0                           # below the bottom
    seeds[40:44] = np.nan                                # dead lanes
    vids, nv, _ = advect._gather_cell_vertices(
        mesh, torch.as_tensor(cells, device=dev))
    table = pack_vertex_table(mesh.vertex_xyz, sol.vertex_ztop,
                              sol.vertex_velocity, sol.vertex_vert_velocity)
    return (torch.as_tensor(seeds, device=dev),
            torch.as_tensor(depth_neg, device=dev), nv, vids, table,
            sol.vertex_ztop.shape[1])


@pytest.mark.cuda
@pytest.mark.parametrize("euler", [False, True], ids=["rk4", "euler"])
def test_kernel_matches_plain_f64(card, euler):
    mesh, sol, dev = card
    args = _step_inputs(mesh, sol, dev)
    before = sk.launch_counts()["k1"]
    got = fused_streamline_step(*args, DT, euler=euler)
    torch.cuda.synchronize()
    assert sk.launch_counts()["k1"] == before + 1
    want = fused_streamline_step_plain(*args, DT, euler=euler)
    for a, b, tol in zip(got[:3], want[:3], (1e-6, 1e-10, 1e-12)):
        torch.testing.assert_close(a, b, rtol=0, atol=tol, equal_nan=True)
    assert torch.equal(got[3], want[3])
    assert not bool(got[3][:16].any()) and bool(got[3][64:].any())


@pytest.mark.cuda
def test_run_kernel_path_matches_plain_path_f64(card):
    mesh, sol, dev = card
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cells = mtt.CellSearch(mesh).query(seeds)
    cfg = mtt.TrajectorySettings(delta_t=600, simulation_duration=600 * 12,
                                 record_t=1200, depth=300.0)
    before = sk.launch_counts()["k1"]
    a = mtt.run_advection(mesh, sol, seeds, cells, cfg, use_window=False)
    assert sk.launch_counts()["k1"] == before + cfg.n_steps
    b = mtt.run_advection(mesh, sol, seeds, cells, cfg, use_kernel=False)
    torch.testing.assert_close(a.points, b.points, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.velocities, b.velocities, rtol=0, atol=1e-10)
    assert torch.equal(a.alive, b.alive)
    assert torch.equal(a.final_cell, b.final_cell)


@pytest.mark.cuda
def test_kernel_ceilings_raise(card):
    mesh, sol, dev = card
    pos, dn, nv, vids, table, L = _step_inputs(mesh, sol, dev)
    wide = torch.zeros((len(nv), 21), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="ceilings"):
        fused_streamline_step(pos, dn, nv, wide, table, L, DT)


def _pathline_inputs(mesh, sol, back, dev, n_attrs):
    pos, dn, nv, vids, _, L = _step_inputs(mesh, sol, dev)
    dn[32:40] = 5.0                                      # above the surface

    def table(s):
        attrs = advect.stacked_vertex_attrs(s)[..., :n_attrs] if n_attrs \
            else None
        return pack_vertex_table(mesh.vertex_xyz, s.vertex_ztop,
                                 s.vertex_velocity, s.vertex_vert_velocity,
                                 attrs)
    return pos, dn, nv, vids, table(sol), table(back), L


@pytest.mark.cuda
@pytest.mark.parametrize("n_attrs", [0, 2])
@pytest.mark.parametrize("euler", [False, True], ids=["rk4", "euler"])
def test_pathline_kernel_matches_plain_f64(card, card_back, euler, n_attrs):
    mesh, sol, dev = card
    args = _pathline_inputs(mesh, sol, card_back, dev, n_attrs)
    for alphas in ((0.3, 0.305, 0.31), (0.996, 1.0, 1.0)):
        before = sk.launch_counts()["k2"]
        got = fused_pathline_step(*args, DT, alphas, euler=euler,
                                  n_attrs=n_attrs)
        torch.cuda.synchronize()
        assert sk.launch_counts()["k2"] == before + 1
        want = fused_pathline_step_plain(*args, DT, alphas, euler=euler,
                                         n_attrs=n_attrs)
        for a, b, tol in zip(got[:3], want[:3], (1e-6, 1e-10, 1e-12)):
            torch.testing.assert_close(a, b, rtol=0, atol=tol, equal_nan=True)
        assert torch.equal(got[3], want[3])
        assert not bool(got[3][:16].any()) and bool(got[3][64:].any())
        if n_attrs:
            torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-8)
            assert bool((got[4][got[3], :2] != 0).all())
        else:
            assert got[4] is None and want[4] is None


@pytest.mark.cuda
def test_pathline_run_kernel_path_matches_plain_path_f64(card, card_back):
    mesh, sol, dev = card
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cells = mtt.CellSearch(mesh).query(seeds)
    cfg = mtt.TrajectorySettings(delta_t=600, simulation_duration=600 * 12,
                                 record_t=1200, depth=300.0)
    before = sk.launch_counts()["k2"]
    a = mtt.run_advection(mesh, sol, seeds, cells, cfg, back=card_back,
                          use_window=False)
    assert sk.launch_counts()["k2"] == before + cfg.n_steps
    b = mtt.run_advection(mesh, sol, seeds, cells, cfg, back=card_back,
                          use_kernel=False)
    torch.testing.assert_close(a.points, b.points, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.velocities, b.velocities, rtol=0, atol=1e-10)
    torch.testing.assert_close(a.attrs, b.attrs, rtol=0, atol=1e-8)
    assert bool(a.attrs.abs().sum() > 0)
    assert torch.equal(a.alive, b.alive)
    assert torch.equal(a.final_cell, b.final_cell)


@pytest.mark.cuda
def test_pathline_kernel_ceilings_raise(card, card_back):
    mesh, sol, dev = card
    pos, dn, nv, vids, tf, tb, L = _pathline_inputs(mesh, sol, card_back,
                                                    dev, 2)
    alphas = (0.3, 0.305, 0.31)
    wide = torch.zeros((len(nv), 21), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="ceilings"):
        fused_pathline_step(pos, dn, nv, wide, tf, tb, L, DT, alphas,
                            n_attrs=2)
    with pytest.raises(ValueError, match="n_attrs"):
        fused_pathline_step(pos, dn, nv, vids, tf, tb, L, DT, alphas,
                            n_attrs=3)


# --- K1 and K2 at wide columns, with non-monotone profiles, and masked -----


def _wide_inputs(kind, L, dev, disturb=True):
    """Pathline inputs (A = 2) at L layers on the Voronoi mesh or on the
    gradient mesh (K = 11), with the ztop columns of every sixth vertex
    disturbed, so that the raw profiles of some lanes ascend somewhere (the
    grouped clamp's slow path); with ``disturb`` false the columns stay
    monotone, and so do the profiles of the lanes inside their cells.
    K1 takes the front table's first table_width(L) columns."""
    rng = np.random.default_rng(L)
    mesh = mtt.synth.build_voronoi_mesh(500, n_layers=L) if kind == "voronoi" \
        else mtt.synth.build_gradient_mesh(2000, n_layers=L)
    raws = [mtt.synth.solid_body_fields(mesh, n_layers=L, w_scale=1e-4,
                                        bathymetry_amp=0.5, omega=omega)
            for omega in (1e-5, 1.2e-5)]
    mesh = mesh.to(dev, torch.float64)
    sols = [mtt.preprocess(mesh, raw, device=dev) for raw in raws]
    n = 256
    v = rng.normal(size=(n, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mtt.EARTH_RADIUS
    cells = mtt.CellSearch(mesh).query(seeds)
    coc = mesh.cells_on_cell.cpu().numpy()
    cells[:16] = coc[cells[:16], 0]                      # out of cell
    seeds[40:44] = np.nan                                # dead lanes
    dn = -np.linspace(10.0, 4500.0, n)                   # down to the bottom
    dn[32:40] = 5.0                                      # above the surface
    vids, nv, _ = advect._gather_cell_vertices(
        mesh, torch.as_tensor(cells, device=dev))
    tf, tb = (pack_vertex_table(mesh.vertex_xyz, s.vertex_ztop,
                                s.vertex_velocity, s.vertex_vert_velocity,
                                advect.stacked_vertex_attrs(s)) for s in sols)
    if disturb:
        bad = torch.as_tensor(rng.choice(len(tf), len(tf) // 6,
                                         replace=False), device=dev)
        noise = torch.as_tensor(rng.uniform(-150.0, 150.0, (len(bad), L)),
                                device=dev)
        tf[bad, 3:3 + L] += noise
        tb[bad, 3:3 + L] -= noise
    pos = torch.as_tensor(seeds, device=dev)
    rows = tf[vids.long()]
    w = wachspress_weights(pos, rows[..., :3], nv)
    z = torch.einsum("nk,nkl->nl", w, rows[..., 3:3 + L])
    ascends = (z[:, 1:] > z[:, :-1]).any(dim=1)
    # the out-of-cell lanes' weights may be negative
    assert bool(ascends.any()) if disturb else not bool(ascends[16:].any())
    return pos, torch.as_tensor(dn, device=dev), nv, vids, tf, tb, L


@pytest.mark.cuda
@pytest.mark.parametrize("kind,L", [("voronoi", 80), ("voronoi", sk.L_MAX),
                                    ("gradient", sk.L_MAX)])
def test_kernel_wide_columns_match_plain_f64(card, kind, L):
    """K1 where L is not a multiple of its lanes a particle, on K = 11
    cells, with lanes whose raw profile is not monotone."""
    _, _, dev = card
    pos, dn, nv, vids, tf, _, L = _wide_inputs(kind, L, dev)
    table = tf[:, :sk.table_width(L)].contiguous()
    if kind == "gradient":
        assert vids.shape[1] == 11
    for euler in (False, True):
        got = fused_streamline_step(pos, dn, nv, vids, table, L, DT,
                                    euler=euler)
        torch.cuda.synchronize()
        want = fused_streamline_step_plain(pos, dn, nv, vids, table, L, DT,
                                           euler=euler)
        for a, b, tol in zip(got[:3], want[:3], (1e-6, 1e-10, 1e-12)):
            torch.testing.assert_close(a, b, rtol=0, atol=tol, equal_nan=True)
        assert torch.equal(got[3], want[3])
        assert bool(got[3].any()) and not bool(got[3][:16].any())


def _listed(only):
    """The masked forms' list of the flagged lanes, in reverse order (the
    window kernel appends them in any order), in an (N,) buffer, and its
    count."""
    idx = torch.nonzero(only)[:, 0].flip(0).to(torch.int32)
    lst = torch.full(only.shape, -1, dtype=torch.int32, device=only.device)
    lst[:len(idx)] = idx
    return lst, torch.tensor([len(idx)], dtype=torch.int32,
                             device=only.device)


@pytest.mark.cuda
@pytest.mark.parametrize("flagged", ["none", "some", "all"])
def test_kernel_masked_form_f64(card, flagged):
    """K1's masked form (the streamline window path's repair launch over the
    window kernel's list of miss lanes): a listed lane's outputs are the
    unmasked step's bit for bit and its layer the full column's at the
    start position; an unlisted lane's outputs stay as they were."""
    _, _, dev = card
    pos, dn, nv, vids, tf, _, L = _wide_inputs("voronoi", 80, dev)
    table = tf[:, :sk.table_width(L)].contiguous()
    n, K = vids.shape
    full = fused_streamline_step(pos, dn, nv, vids, table, L, DT)
    only = {"none": torch.zeros(n, dtype=torch.bool, device=dev),
            "some": torch.arange(n, device=dev) % 7 == 3,
            "all": torch.ones(n, dtype=torch.bool, device=dev)}[flagged]
    out = [torch.full_like(pos, 7.0), torch.full_like(pos, 7.0),
           torch.full_like(dn, 7.0), torch.zeros_like(only),
           torch.full((n,), -5, dtype=torch.int32, device=dev)]
    lst, cnt = _listed(only)
    err = sk._library().streamline_step_f64(
        pos.data_ptr(), dn.data_ptr(), nv.data_ptr(), vids.data_ptr(),
        table.data_ptr(), n, K, table.shape[1], L, DT, 0,
        *(t.data_ptr() for t in out[:4]), lst.data_ptr(), cnt.data_ptr(),
        out[4].data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for a, b in zip(out[:4], full):
        torch.testing.assert_close(a[only], b[only], rtol=0, atol=0,
                                   equal_nan=True)
    assert bool((out[0][~only] == 7.0).all()) and not bool(out[3][~only].any())
    assert bool((out[2][~only] == 7.0).all()) and bool((out[4][~only] == -5).all())
    rows = table[vids.long()]
    layer = torch.clamp(start_layer(rows[..., 3:3 + L], pos, dn, nv,
                                    rows[..., :3], False), 1, L - 1)
    assert torch.equal(out[4][only], layer[only].to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_window_streamline_step_bit_equal_to_kernel(card, dtype):
    """Over monotone columns at the main path's L = 60 and W = 8, a lane
    whose window step does not miss takes K1's step bit for bit (K3 rounds
    as K1 does), and a miss lane K1's masked repair: the window path's
    agreement with the full-column path over a whole day rests on it."""
    _, _, dev = card
    pos, dn, nv, vids, tf, _, L = _wide_inputs("voronoi", 60, dev,
                                               disturb=False)
    table = tf[:, :sk.table_width(L)].to(dtype).contiguous()
    pos, dn = pos.to(dtype), dn.to(dtype)
    rows = table[vids.long()]
    s = window_starts(start_layer(rows[..., 3:3 + L], pos, dn, nv,
                                  rows[..., :3], False), L, 8)
    moved = torch.arange(len(s), device=dev) % 5 == 2    # these miss
    s = torch.where(moved, torch.clamp(s + 8, 0, L - 8), s).to(
        torch.int32).contiguous()
    rise = sk.table_rise(table, L)
    for euler in (False, True):
        win = sk.fused_window_streamline_step(pos, dn, nv, vids, s, table,
                                              rise, L, 8, DT, euler=euler)
        full = fused_streamline_step(pos, dn, nv, vids, table, L, DT,
                                     euler=euler)
        torch.cuda.synchronize()
        assert 0 < int(win[5].sum()) < len(nv) // 2
        assert bool(win[3][~win[5]].any())
        # monotone columns: no clamp miss off the dead lanes (a NaN
        # position's weights are NaN, not >= 0)
        assert not bool(win[6][torch.isfinite(pos).all(dim=1)].any())
        for a, b in zip(win[:4], full):
            assert torch.equal(a.nan_to_num(1.5), b.nan_to_num(1.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("L", [60, 80])
@pytest.mark.parametrize("kernel", ["k3", "k4"])
def test_window_kernels_equal_full_step_on_ascending_columns(card, kernel, L,
                                                             dtype):
    """Where raw ztop columns ascend (every sixth vertex disturbed), the
    window kernels give K1's (K2's) outputs bit for bit on every lane, at
    L60 (the L <= 64 repair instance) and L80 (the generic one): a lane
    either computes what the full column computes or is flagged (edge or
    clamp miss) and repaired.  Some lanes only the clamp test flags."""
    _, _, dev = card
    pos, dn, nv, vids, tf, tb, L = (
        a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a
        for a in _wide_inputs("voronoi", L, dev))
    F = sk.table_width(L, 2 if kernel == "k4" else 0)
    tf, tb = tf[:, :F].contiguous(), tb[:, :F].contiguous()
    rows = tf[vids.long()]
    s = window_starts(start_layer(rows[..., 3:3 + L], pos, dn, nv,
                                  rows[..., :3], kernel == "k4"), L, 8)
    s = s.contiguous()
    alphas = (0.3, 0.305, 0.31)
    for euler in (False, True):
        if kernel == "k3":
            win = sk.fused_window_streamline_step(
                pos, dn, nv, vids, s, tf, sk.table_rise(tf, L), L, 8, DT,
                euler=euler)
            full = fused_streamline_step(pos, dn, nv, vids, tf, L, DT,
                                         euler=euler)
        else:
            win = sk.fused_window_pathline_step(
                pos, dn, nv, vids, s, tf, tb, sk.table_rise(tf, L),
                sk.table_rise(tb, L), L, 8, DT, alphas, euler=euler,
                n_attrs=2)
            full = fused_pathline_step(pos, dn, nv, vids, tf, tb, L, DT,
                                       alphas, euler=euler, n_attrs=2)
        torch.cuda.synchronize()
        clamp = win[6]
        assert bool(clamp.any()) and bool((~win[5]).any())
        assert not bool((clamp & ~win[5]).any())
        outs = list(zip(win[:4], full[:4]))
        if kernel == "k4":
            outs.append((win[7], full[4]))
        for a, b in outs:
            assert torch.equal(a.nan_to_num(1.5), b.nan_to_num(1.5))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,L", [("voronoi", 80), ("voronoi", sk.L_MAX),
                                    ("gradient", sk.L_MAX)])
def test_pathline_kernel_wide_columns_match_plain_f64(card, kind, L):
    """K2 where L is not a multiple of its lanes a particle, on K = 11
    cells, with lanes whose raw profile is not monotone."""
    _, _, dev = card
    args = _wide_inputs(kind, L, dev)
    if kind == "gradient":
        assert args[3].shape[1] == 11
    for euler in (False, True):
        got = fused_pathline_step(*args, DT, (0.3, 0.305, 0.31), euler=euler,
                                  n_attrs=2)
        torch.cuda.synchronize()
        want = fused_pathline_step_plain(*args, DT, (0.3, 0.305, 0.31),
                                         euler=euler, n_attrs=2)
        for a, b, tol in zip(got[:3], want[:3], (1e-6, 1e-10, 1e-12)):
            torch.testing.assert_close(a, b, rtol=0, atol=tol, equal_nan=True)
        assert torch.equal(got[3], want[3])
        torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-8)
        assert bool(got[3].any()) and not bool(got[3][:16].any())


@pytest.mark.cuda
@pytest.mark.parametrize("flagged", ["none", "some", "all"])
def test_pathline_kernel_masked_form_f64(card, flagged):
    """K2's masked form (the window path's repair launch over the window
    kernel's list of miss lanes): a listed lane's outputs are the unmasked
    step's and its layer the front column's at the start position; an
    unlisted lane's outputs stay as they were."""
    _, _, dev = card
    pos, dn, nv, vids, tf, tb, L = _wide_inputs("voronoi", 80, dev)
    n, K = vids.shape
    alphas = (0.3, 0.305, 0.31)
    full = fused_pathline_step(pos, dn, nv, vids, tf, tb, L, DT, alphas,
                               n_attrs=2)
    only = {"none": torch.zeros(n, dtype=torch.bool, device=dev),
            "some": torch.arange(n, device=dev) % 7 == 3,
            "all": torch.ones(n, dtype=torch.bool, device=dev)}[flagged]
    out = [torch.full_like(pos, 7.0), torch.full_like(pos, 7.0),
           torch.full_like(dn, 7.0), torch.zeros_like(only),
           torch.full_like(pos, 7.0),
           torch.full((n,), -5, dtype=torch.int32, device=dev)]
    lst, cnt = _listed(only)
    err = sk._library().pathline_step_f64(
        pos.data_ptr(), dn.data_ptr(), nv.data_ptr(), vids.data_ptr(),
        tf.data_ptr(), tb.data_ptr(), n, K, tf.shape[1], L, 2, DT, *alphas, 0,
        *(t.data_ptr() for t in out[:5]), lst.data_ptr(), cnt.data_ptr(),
        out[5].data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for a, b in zip(out[:5], full[:5]):
        torch.testing.assert_close(a[only], b[only], rtol=0, atol=0,
                                   equal_nan=True)
    assert bool((out[0][~only] == 7.0).all()) and not bool(out[3][~only].any())
    assert bool((out[4][~only] == 7.0).all()) and bool((out[5][~only] == -5).all())
    rows = tf[vids.long()]
    layer = torch.clamp(start_layer(rows[..., 3:3 + L], pos, dn, nv,
                                    rows[..., :3], True), 1, L - 1)
    assert torch.equal(out[5][only], layer[only].to(torch.int32))


# --- the layer-window kernels (K3, K4) ---------------------------------------

W = 4


def _window_starts(pos, dn, nv, vids, table, L):
    """Starts around each lane's layer, moved to the far end of the column
    on a third of the lanes (every third) so that their depth leaves the
    window or nears its edge (misses)."""
    rows = table[vids.long()]
    layer = start_layer(rows[..., 3:3 + L], pos, dn, nv, rows[..., :3], False)
    s = window_starts(layer, L, W)
    far = torch.where(s < (L - W + 1) // 2, L - W, 0)
    moved = torch.arange(len(s), device=s.device) % 3 == 2
    return torch.where(moved, far, s).to(torch.int32).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["streamline", "pathline_0", "pathline_2"])
@pytest.mark.parametrize("euler", [False, True], ids=["rk4", "euler"])
def test_window_kernel_matches_plain_f64(card, card_back, path, euler):
    mesh, sol, dev = card
    if path == "streamline":
        pos, dn, nv, vids, table, L = _step_inputs(mesh, sol, dev)
        dn[60:120] = -torch.linspace(10.0, 3900.0, 60, dtype=dn.dtype)
        s = _window_starts(pos, dn, nv, vids, table, L)
        fn, plain = sk.fused_window_streamline_step, \
            sk.fused_window_streamline_step_plain
        args, extra, kw = (pos, dn, nv, vids, s, table,
                           sk.table_rise(table, L), L, W, DT), (), {}
    else:
        n_attrs = int(path[-1])
        pos, dn, nv, vids, tf, tb, L = _pathline_inputs(mesh, sol, card_back,
                                                        dev, n_attrs)
        dn[60:120] = -torch.linspace(10.0, 3900.0, 60, dtype=dn.dtype)
        s = _window_starts(pos, dn, nv, vids, tf, L)
        fn, plain = sk.fused_window_pathline_step, \
            sk.fused_window_pathline_step_plain
        args, extra = (pos, dn, nv, vids, s, tf, tb, sk.table_rise(tf, L),
                       sk.table_rise(tb, L), L, W, DT), ((0.996, 1.0, 1.0),)
        kw = {"n_attrs": n_attrs}
    key, full = ("k3", "k1") if path == "streamline" else ("k4", "k2")
    keys = lambda c: (c[key], c[f"{key} repair"], c[full])
    before = keys(sk.launch_counts())
    got = fn(*args, *extra, euler=euler, **kw)
    torch.cuda.synchronize()
    # one window launch and one masked repair launch; K1/K2's own count
    # does not move
    assert keys(sk.launch_counts()) \
        == (before[0] + 1, before[1] + 1, before[2])
    want = plain(*args, *extra, euler=euler, **kw)
    for a, b, tol in zip(got[:3], want[:3], (1e-6, 1e-10, 1e-12)):
        torch.testing.assert_close(a, b, rtol=0, atol=tol, equal_nan=True)
    for a, b in zip(got[3:7], want[3:7]):         # ok, layer, miss, clamp
        assert torch.equal(a, b)
    assert 0 < int(got[5].sum()) < len(nv) // 2           # some lanes missed
    assert not bool(got[3][:16].any()) and bool(got[3][64:].any())
    if path == "pathline_2":
        torch.testing.assert_close(got[7], want[7], rtol=0, atol=1e-8)
    elif path != "streamline":
        assert got[7] is None and want[7] is None


@pytest.mark.cuda
@pytest.mark.parametrize("pathline", [False, True],
                         ids=["streamline", "pathline"])
def test_windowed_run_matches_plain_path_f64(card, card_back, pathline,
                                            monkeypatch):
    """A run on the card takes the window kernels by default and matches
    the plain path."""
    mesh, sol, dev = card
    back = card_back if pathline else None
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cells = mtt.CellSearch(mesh).query(seeds)
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32))
    key, full = ("k4", "k2") if pathline else ("k3", "k1")
    keys = lambda c: (c[key], c[f"{key} repair"], c[full])
    monkeypatch.setattr(advect, "WINDOW_LAYERS", W)
    before = keys(sk.launch_counts())
    a = mtt.run_advection(mesh, sol, seeds, cells, cfg, back=back)
    # one window launch and one masked repair launch a step, no K1/K2 launch
    assert keys(sk.launch_counts()) == (
        before[0] + cfg.n_steps, before[1] + cfg.n_steps, before[2])
    b = mtt.run_advection(mesh, sol, seeds, cells, cfg, back=back,
                          use_kernel=False)
    torch.testing.assert_close(a.points, b.points, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.velocities, b.velocities, rtol=0, atol=1e-10)
    if pathline:
        torch.testing.assert_close(a.attrs, b.attrs, rtol=0, atol=1e-8)
    assert torch.equal(a.alive, b.alive)
    assert torch.equal(a.final_cell, b.final_cell)
    assert a.window_misses is not None and b.window_misses is None


@pytest.mark.cuda
def test_window_kernel_ceilings_raise(card):
    mesh, sol, dev = card
    pos, dn, nv, vids, table, L = _step_inputs(mesh, sol, dev)
    s = torch.zeros(len(nv), dtype=torch.int32, device=dev)
    wide = torch.zeros((len(nv), 21), dtype=torch.int32, device=dev)
    rise = sk.table_rise(table, L)
    with pytest.raises(ValueError, match="ceilings"):
        sk.fused_window_streamline_step(pos, dn, nv, wide, s, table, rise, L,
                                        W, DT)
    with pytest.raises(ValueError, match="window"):
        sk.fused_window_streamline_step(pos, dn, nv, vids, s, table, rise, L,
                                        L + 1, DT)
    with pytest.raises(ValueError, match="rise"):
        sk.fused_window_streamline_step(pos, dn, nv, vids, s, table,
                                        rise.long(), L, W, DT)


# --- the row-gather probe (K5) ------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("row_bytes", [16, 1216, 1696, 12288])
def test_row_gather_matches_plain(card, dtype, row_bytes):
    """Rows of 16 B, of the slice's streamline (1,216 B) and pathline front
    (1,696 B) tables and of prof_dma.py's (12,288 B), with repeated ids."""
    rng = np.random.default_rng(row_bytes)
    F = row_bytes // torch.empty((), dtype=dtype).element_size()
    table = torch.as_tensor(rng.normal(size=(1000, F)), dtype=dtype,
                            device="cuda")
    ids = torch.as_tensor(rng.integers(0, 1000, size=(4 * rg.BLOCK_ROWS,)),
                          dtype=torch.int32, device="cuda")
    ids[5:40] = ids[4]
    ids[700:900] = ids[600:800].clone()
    before = rg.row_gather_probe.launches
    head, sums = rg.row_gather_probe(table, ids)
    torch.cuda.synchronize()
    assert rg.row_gather_probe.launches == before + 1
    want_head, want_sums = rg.row_gather_plain(table, ids)
    scale = rg.row_gather_plain(table.abs(), ids)[1]
    assert torch.equal(head, want_head)
    assert bool(((sums - want_sums).abs() <= 1e-12 * scale).all())


@pytest.mark.cuda
def test_row_gather_raises_on_bad_ids(card):
    table = torch.zeros((10, 256), dtype=torch.float32, device="cuda")
    ids = torch.zeros(32, dtype=torch.int32, device="cuda")
    ids[5] = 10
    with pytest.raises(ValueError, match="outside"):
        rg.row_gather_probe(table, ids, 16)


# --- remap and the API on the card -------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["depth", "layer", "regrid"])
def test_remap_on_the_card_matches_cpu_f64(card, entry):
    """chip_smoke.py's remap row gate at a small size: the card's float64
    images against the same remap on CPU tensors, NaN masks equal and
    values within 1e-9 of the image's largest magnitude."""
    mesh, sol, dev = card
    search = mtt.CellSearch(mesh)
    on_card = mtt.Field(mesh, sol, device="cuda", _search=search)
    on_cpu = mtt.Field(mesh.to("cpu"), sol.to("cpu"), device="cpu",
                       _search=search)
    if entry == "depth":
        def run(f):
            return mtt.remap.run_remapping(f, mtt.VisualizationSettings(
                image_width=96, image_height=48, fixed_depth=300.0), chunk=999)
    elif entry == "layer":
        def run(f):
            return [mtt.remap.run_fixed_layer(f, mtt.VisualizationSettings(
                image_width=96, image_height=48, fixed_layer=3))]
    else:
        def run(f):
            return [mtt.remap.run_regrid(f, mtt.VisualizationSettings(
                image_width=96, image_height=6, fixed_latitude=20.0))]
    for got, want in zip(run(on_card), run(on_cpu)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isfinite(want).any()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.nanmax(np.abs(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("pathline", [False, True],
                         ids=["streamline", "pathline"])
def test_api_lines_equal_direct_run(card, card_back, pathline):
    """MOPSApp on the card gives the lines of a direct run_advection on the
    same fields, seeds and settings, bit for bit (the same kernels)."""
    mesh, sol, dev = card
    app = mtt.MOPSApp()
    app.init("cuda", "fp64")
    app.begin()
    app.add_grid(mesh)
    app.add_solution(1, sol)
    app.add_solution(2, card_back)
    app.end()
    app.active_attribute(*((1, 2) if pathline else (1,)))
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32), fail_mode=mtt.FailMode.ZERO)
    key = "k4" if pathline else "k3"
    before = sk.launch_counts()[key]
    pts = seeds.copy()
    lines = (app.run_pathline if pathline else app.run_streamline)(cfg, pts)
    assert sk.launch_counts()[key] == before + cfg.n_steps
    back = card_back if pathline else None
    raw = mtt.run_advection(mesh, sol, seeds, mtt.CellSearch(mesh).query(seeds),
                            cfg, back=back)
    want = mtt.finalize_trajectories(
        seeds, raw.points.cpu().numpy(), raw.velocities.cpu().numpy(), cfg,
        attrs=raw.attrs.cpu().numpy() if pathline else None,
        with_attrs=pathline)
    for a, b in zip(lines, want):
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.velocity, b.velocity)
    if pathline:
        np.testing.assert_array_equal(pts, np.stack([l.last_point
                                                     for l in want]))


@pytest.mark.cuda
def test_f64_launches_count_the_double_instances(card, card_back):
    """Through the API on the card, every step-kernel launch of an fp64
    request counts under kernels.f64_launches.<key> as well, and none of
    an fp32 request's does; each request's span keeps the app's precision
    and the path its run resolved."""
    from mops_tpu_torch.utils.timer import TimerManager
    mesh, sol, dev = card
    mgr = TimerManager.instance()
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32), fail_mode=mtt.FailMode.ZERO)
    for precision in ("fp64", "fp32"):
        app = mtt.MOPSApp()
        app.init("cuda", precision)
        app.begin()
        app.add_grid(mesh)
        app.add_solution(1, sol)
        app.add_solution(2, card_back)
        app.end()
        for pathline in (False, True):
            app.active_attribute(*((1, 2) if pathline else (1,)))
            run = app.run_pathline if pathline else app.run_streamline
            run(cfg, seeds.copy())
            top = [s for s in mgr.spans()
                   if s.name == ("api.pathline" if pathline
                                 else "api.streamline")][-1]
            counts = mgr.counters()[top.request]
            launches = {k[len(sk.LAUNCHES):]: n for k, n in counts.items()
                        if k.startswith(sk.LAUNCHES)}
            f64 = {k[len(sk.F64_LAUNCHES):]: n for k, n in counts.items()
                   if k.startswith(sk.F64_LAUNCHES)}
            key = "k4" if pathline else "k3"
            assert launches == {key: cfg.n_steps,
                                f"{key} repair": cfg.n_steps}
            assert f64 == (launches if precision == "fp64" else {})
            path = top.meta["path"]
            assert top.meta["precision"] == precision
            assert (path["kernel"], path["dtype"]) == (
                key, "float64" if precision == "fp64" else "float32")


@pytest.mark.cuda
def test_finalize_on_the_card_equals_host_finalize(card, card_back):
    """Lines finalized from records on the card equal those finalized from
    the same records copied to the host first, bit for bit;
    trajectory.cut_lines counts exactly the lines planted with a
    non-finite record; run_pathline's chained seeds are the lines' last
    points."""
    from torch.profiler import ProfilerActivity, profile
    from mops_tpu_torch.utils.timer import TimerManager
    mesh, sol, dev = card
    gen = torch.Generator(device=dev).manual_seed(5)
    n, r = 3000, 40
    seeds = np.random.default_rng(5).normal(size=(n, 3)) * 6.4e6
    pts = torch.randn((n, r, 3), generator=gen, device=dev) * 6.4e6
    vels = torch.randn((n, r, 3), generator=gen, device=dev)
    attrs = torch.randn((n, r, 3), generator=gen, device=dev)
    planted = torch.randperm(n, generator=gen, device=dev)[:97]
    where = torch.randint(0, r, (97,), generator=gen, device=dev)
    pts[planted[:60], where[:60], 1] = float("nan")
    pts[planted[60:], where[60:], 0] = float("inf")
    seeds[5, 0] = np.nan            # a non-finite seed: one more line
    n_cut = len(set(planted.tolist()) | {5})
    cfg = mtt.TrajectorySettings(delta_t=60, record_t=60,
                                 simulation_duration=60 * r,
                                 particle_depths=np.linspace(1, 900, n))
    mgr = TimerManager.instance()
    for with_attrs in (False, True):
        a = attrs if with_attrs else None
        with profile(activities=[ProfilerActivity.CPU]):
            with mgr.request("api.test"):
                got = mtt.finalize_trajectories(seeds, pts, vels, cfg,
                                                attrs=a,
                                                with_attrs=with_attrs)
        rid = [s.request for s in mgr.spans() if s.name == "api.test"][-1]
        assert mgr.counters()[rid]["trajectory.cut_lines"] == n_cut
        want = mtt.finalize_trajectories(
            seeds, pts.cpu(), vels.cpu(), cfg,
            attrs=None if a is None else a.cpu(), with_attrs=with_attrs)
        assert type(got) is list and len(got) == len(want) == n
        for x, y in zip(got, want):
            assert (x.line_id, x.duration, x.timestamp, x.depth) == \
                (y.line_id, y.duration, y.timestamp, y.depth)
            for f in ("points", "velocity", "temperature", "salinity",
                      "last_point", "attrs"):
                u, v = getattr(x, f), getattr(y, f)
                if v is None:
                    assert u is None
                    continue
                assert (u.dtype, u.shape) == (v.dtype, v.shape)
                assert u.tobytes() == v.tobytes(), (f, x.line_id)
    app = mtt.MOPSApp()
    app.init("cuda", "fp64")
    app.begin()
    app.add_grid(mesh)
    app.add_solution(1, sol)
    app.add_solution(2, card_back)
    app.end()
    app.active_attribute(1, 2)
    chained = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    first = chained.copy()
    lines = app.run_pathline(mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200), chained)
    assert not np.array_equal(chained, first)
    np.testing.assert_array_equal(chained,
                                  np.stack([l.last_point for l in lines]))


@pytest.mark.cuda
def test_api_reads_back_into_prepared_host_blocks(card, card_back,
                                                  monkeypatch):
    """Through the API on the card each request's host blocks are made
    resident on the app's worker and the read-back copies into them:
    streamline and pathline lines equal those read back by ``.cpu()`` bit
    for bit, the blocks are not pinned, two requests' lines share no
    storage, and every block counts as read back and ready (none ready
    without the prepared blocks)."""
    from mops_tpu_torch import trajectory
    from mops_tpu_torch.utils.timer import TimerManager
    mesh, sol, dev = card
    mgr = TimerManager.instance()
    made = []
    real = trajectory.host_blocks
    monkeypatch.setattr(trajectory, "host_blocks",
                        lambda *a: made.append(real(*a)) or made[-1])
    app = mtt.MOPSApp()
    app.init("cuda", "fp64")
    app.begin()
    app.add_grid(mesh)
    app.add_solution(1, sol)
    app.add_solution(2, card_back)
    app.end()
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32), fail_mode=mtt.FailMode.ZERO)
    fields = ("points", "velocity", "temperature", "salinity", "last_point",
              "attrs")

    def request(run):
        lines = run(cfg, seeds.copy())
        rid = [s.request for s in mgr.spans()
               if s.name.startswith("api.")][-1]
        counts = mgr.counters()[rid]
        return lines, (counts["trajectory.readback_blocks"],
                       counts["trajectory.readback_ready"])

    for pathline in (False, True):
        app.active_attribute(*((1, 2) if pathline else (1,)))
        run = app.run_pathline if pathline else app.run_streamline
        n = 4 if pathline else 2
        del made[:]
        first, c1 = request(run)
        second, c2 = request(run)
        assert c1 == c2 == (n, n)
        assert len(made) == 2 and all(len(b) == n for b in made)
        with monkeypatch.context() as m:
            m.setattr(app, "_host_blocks", lambda *a: None)
            plain, c0 = request(run)
        assert c0 == (n, 0)
        for lines in (first, second):
            assert len(lines) == len(plain) == len(seeds)
            for x, y in zip(lines, plain):
                for f in fields:
                    u, v = getattr(x, f), getattr(y, f)
                    assert (u is None) == (v is None), f
                    if v is not None:
                        assert (u.dtype, u.shape) == (v.dtype, v.shape), f
                        assert u.tobytes() == v.tobytes(), (f, x.line_id)
        for lines, blocks in zip((first, second), made):
            assert not any(b.is_pinned() for b in blocks.values())
            assert np.shares_memory(lines[0].points, blocks["pts"].numpy())
            assert not torch.from_numpy(lines[0].points).is_pinned()

        def ranges(blocks):
            return [(b.data_ptr(), b.data_ptr() + b.nbytes)
                    for b in blocks.values()]
        for a0, a1 in ranges(made[0]):
            for b0, b1 in ranges(made[1]):
                assert a1 <= b0 or b1 <= a0
        assert not np.shares_memory(first[0].points, second[0].points)


def _card_run(card, card_back, pathline, f32):
    """Seeds, cells, settings and tables of a small multi-device run on the
    card (float32 when ``f32``, the main path's dtype)."""
    mesh, sol, dev = card
    real = torch.float32 if f32 else torch.float64
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(21, 21), lat_range=(-70, 70), lon_range=(-180, 180)))
    cfg = mtt.TrajectorySettings(
        delta_t=3600, simulation_duration=3600 * 24, record_t=3600 * 4,
        particle_depths=np.linspace(10.0, 3000.0, len(seeds)).astype(
            np.float32), fail_mode=mtt.FailMode.ZERO)
    back = card_back.to(dev, real) if pathline else None
    return (mesh.to(dev, real), sol.to(dev, real), back, seeds,
            mtt.CellSearch(mesh).query(seeds), cfg, real)


@pytest.mark.cuda
@pytest.mark.parametrize("pathline", [False, True],
                         ids=["streamline", "pathline"])
def test_sharded_on_the_card_equals_single_device(card, card_back, pathline):
    """4 shards on one card: the single-device run bit for bit, and 4x its
    window-kernel launches (chip_smoke.py phase 6a at a small size)."""
    from mops_tpu_torch.parallel import run_advection_sharded
    mesh, sol, back, seeds, cells, cfg, _ = _card_run(card, card_back,
                                                      pathline, True)
    dev = card[2]
    key = "k4" if pathline else "k3"
    keys = lambda c: (c[key], c[f"{key} repair"])
    single = mtt.run_advection(mesh, sol, seeds, cells, cfg, back=back)
    before = keys(sk.launch_counts())
    got = run_advection_sharded(mesh, sol, seeds, cells, cfg,
                                devices=[dev] * 4, back=back)
    assert keys(sk.launch_counts()) == \
        (before[0] + 4 * cfg.n_steps, before[1] + 4 * cfg.n_steps)
    for f in ("points", "velocities", "attrs", "final_position",
              "final_depth", "alive", "window_misses"):
        a, b = getattr(got, f), getattr(single, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("use_window", [True, False],
                         ids=["window", "full_column"])
@pytest.mark.parametrize("pathline", [False, True],
                         ids=["streamline", "pathline"])
def test_migrating_on_the_card_equals_single_device(card, card_back,
                                                    pathline, use_window):
    """8 shards on one card through the kernels (K3/K4 with their repair,
    or K1/K2) against shard-local tables: particles migrate, none is
    dropped, and every trajectory is the single-device run's bit for bit
    (chip_smoke.py phase 6b/6c at a small size)."""
    from mops_tpu_torch.parallel import reassemble, run_advection_migrating
    mesh, sol, back, seeds, cells, cfg, real = _card_run(
        card, card_back, pathline, True)
    dev = card[2]
    key = ("k2" if pathline else "k1") if not use_window else \
        ("k4" if pathline else "k3")
    single = mtt.run_advection(mesh, sol, seeds, cells, cfg, back=back,
                               use_window=use_window)
    before = sk.launch_counts()[key]
    res = run_advection_migrating(mesh, sol, seeds, cells, cfg,
                                  devices=[dev] * 8, dtype=real, back=back,
                                  migrate_every=3, use_window=use_window)
    assert sk.launch_counts()[key] == before + 8 * cfg.n_steps
    assert int(res.dropped.sum()) == 0 and int(res.migrated.sum()) > 0
    ids = res.final_ids.cpu().numpy()
    assert sorted(ids[ids >= 0].tolist()) == list(range(len(seeds)))
    points, vels, attrs, fpos, fdepth = reassemble(res, len(seeds), seeds)
    assert torch.equal(points, single.points)
    assert torch.equal(vels, single.velocities)
    assert torch.equal(fpos, single.final_position)
    assert torch.equal(fdepth, single.final_depth)
    if pathline:
        assert torch.equal(attrs, single.attrs)


# --- the generic (L > 64) instances of K2 and K4, the L80 path ------------


def _close_f32(got, want, flags, values):
    """Kernel vs plain at float32 (chip_smoke.py's tolerances): the lanes
    that agree on every flag within 2 m (4 ulp at Earth radius) in position
    (output 0) and within 1e-4 of the largest magnitude in the other
    ``values``; at most one lane (at most 1e-4 of them, rounded up) may
    flip a flag, a rounding difference at a cell edge or a layer
    interface."""
    same = torch.ones_like(want[3])
    for i in flags:
        same &= got[i] == want[i]
    assert int((~same).sum()) <= max(1, int(1e-4 * len(same)))
    for i in values:
        a, b = got[i][same], want[i][same]
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        tol = 2.0 if i == 0 else 1e-4 * float(b.abs().nan_to_num(0).max())
        assert float((a - b).abs().nan_to_num(0).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("L", [80, sk.L_MAX])
@pytest.mark.parametrize("kernel", ["k2", "k4"])
def test_generic_pathline_kernels_match_plain(card, kernel, L, dtype):
    """K2 and K4 (with its masked K2 repair) at L80 and L_MAX, the generic
    instance, against their plain versions, with 0 and 2 attributes, RK4
    and Euler; float64 at test_pallas.py's tolerances, float32 at
    chip_smoke.py's."""
    _, _, dev = card
    pos, dn, nv, vids, tf, tb, L = (
        a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a
        for a in _wide_inputs("voronoi", L, dev, disturb=kernel == "k2"))
    assert sk.column_instance(L) == "generic"
    s = _window_starts(pos, dn, nv, vids, tf, L) if kernel == "k4" else None
    alphas = (0.3, 0.305, 0.31)
    for n_attrs in (0, 2):
        F = sk.table_width(L, n_attrs)
        tabs = (tf[:, :F].contiguous(), tb[:, :F].contiguous())
        for euler in (False, True):
            if kernel == "k2":
                fn, plain = fused_pathline_step, fused_pathline_step_plain
                args, flags, attr = (pos, dn, nv, vids, *tabs), (3,), 4
                extra = (L, DT, alphas)
            else:
                fn, plain = (sk.fused_window_pathline_step,
                             sk.fused_window_pathline_step_plain)
                args, flags, attr = (pos, dn, nv, vids, s, *tabs,
                                     *(sk.table_rise(t, L) for t in tabs)), \
                    (3, 4, 5, 6), 7
                extra = (L, W, DT, alphas)
            # K2, or K4's masked K2 repair: the generic instance (above)
            key = "k2" if kernel == "k2" else "k4 repair"
            before = sk.launch_counts()[key]
            got = fn(*args, *extra, euler=euler, n_attrs=n_attrs)
            torch.cuda.synchronize()
            assert sk.launch_counts()[key] == before + 1
            want = plain(*args, *extra, euler=euler, n_attrs=n_attrs)
            if dtype == torch.float64:
                for a, b, tol in zip(got[:3], want[:3], (1e-6, 1e-10, 1e-12)):
                    torch.testing.assert_close(a, b, rtol=0, atol=tol,
                                               equal_nan=True)
                for i in flags:
                    assert torch.equal(got[i], want[i])
                if n_attrs:
                    torch.testing.assert_close(got[attr], want[attr], rtol=0,
                                               atol=1e-8)
            else:
                _close_f32(got, want, flags,
                           (0, 1, 2) + ((attr,) if n_attrs else ()))
            assert (got[attr] is None) == (n_attrs == 0)
            assert bool(got[3].any()) and not bool(got[3][:16].any())
            if kernel == "k4":
                assert 0 < int(got[5].sum()) < len(nv)


@pytest.mark.cuda
@pytest.mark.parametrize("use_window", [True, False],
                         ids=["window", "full-column"])
def test_l80_kernel_path_matches_oracle(card, use_window):
    """The kernel path's float64 trajectories at L80 (K3 with its generic
    masked K1 repair, or the generic K1) against the port's scalar oracle
    (mops_tpu_torch.oracle, NumPy only: the reference where there is no
    jax), at tests/test_advect.py's tolerances."""
    from mops_tpu_torch.oracle import oracle_streamline
    _, _, dev = card
    L = 80
    mesh = mtt.synth.build_voronoi_mesh(500, n_layers=L)
    raw = mtt.synth.solid_body_fields(mesh, n_layers=L, w_scale=1e-3,
                                      bathymetry_amp=0.5)
    sol = mtt.preprocess(mesh, raw, device="cpu")
    rng = np.random.default_rng(80)
    v = rng.normal(size=(32, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mtt.EARTH_RADIUS
    cells = mtt.CellSearch(mesh).query(seeds)
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 6, record_t=1200,
        particle_depths=np.linspace(10.0, 3000.0, 32).astype(np.float32))
    # K1 at L80 is the generic instance: K3's repair, or every full step
    key = "k3 repair" if use_window else "k1"
    before = sk.launch_counts()[key]
    got = mtt.run_advection(mesh, sol, seeds, cells, cfg, device=dev,
                            use_window=use_window)
    assert advect.LAST_RESOLVED["instance"] == "generic"
    assert advect.LAST_RESOLVED["kernel"] == ("k3" if use_window else "k1")
    assert sk.column_instance(L) == "generic"
    assert sk.launch_counts()[key] == before + cfg.n_steps
    pts, vels, final, depths = oracle_streamline(mesh, sol, seeds, cells, cfg)
    np.testing.assert_allclose(got.points.cpu().numpy(), pts, rtol=0,
                               atol=5e-6)
    np.testing.assert_allclose(got.velocities.cpu().numpy(), vels, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.final_position.cpu().numpy(), final,
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(got.final_depth.cpu().numpy(), depths,
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_detail_under_a_cuda_profiler(card, monkeypatch):
    """Under a CUDA-only torch.profiler, as the benchmark's traced runs
    take it, a window-path streamline records detail: the step loop's
    phases with stream time, on the profile's time axis (every step kernel
    starts after advect.loop's start and ends before its end is read), and
    detail launches nothing of its own: the kernels and copies are the
    same, name for name, with the detail predicate forced off, but for the
    capture bookkeeping of the graphs it captures a phase apart."""
    import collections
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tm = importlib.import_module("mops_tpu_torch.utils.timer")
    mesh, sol, dev = card
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cells = mtt.CellSearch(mesh).query(seeds)
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32))
    mgr = tm.TimerManager.instance()
    monkeypatch.setattr(advect, "WINDOW_LAYERS", W)

    def traced():
        mgr.reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with mgr.request("api.test"):
                detail = mgr.detail()
                mtt.run_advection(mesh, sol, seeds, cells, cfg)
            torch.cuda.synchronize()
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        return detail, events, mgr.spans()

    traced()                                      # builds and warms up
    detail, events, spans = traced()
    assert detail
    assert advect.LAST_RESOLVED["kernel"] == "k3"
    loop = [s for s in spans if s.name == "advect.loop"][0]
    phases = [s for s in spans if s.name in advect.PHASES]
    assert [s.name for s in phases] == list(advect.PHASES)
    assert all(s.parent == loop.id and s.device_ms > 0 for s in phases)
    assert sum(s.device_ms for s in phases) <= loop.device_ms
    steps = [e for e in events if "window_streamline_kernel" in e[0]]
    assert len(steps) == cfg.n_steps
    assert all(loop.start_ns <= s for _, s, _ in steps)
    assert max(e for _, _, e in steps) <= time.time_ns()
    monkeypatch.setattr(tm, "profiling", lambda: False)
    off, events_off, spans_off = traced()
    assert not off and not any(s.name in advect.PHASES for s in spans_off)
    on = collections.Counter(n for n, _, _ in events)
    off = collections.Counter(n for n, _, _ in events_off)
    # the same kernels and copies, but that detail captures the graphed
    # step a phase a graph (one graph without it), and torch fills two
    # int64 scalars of its generator's state at each capture
    assert not off - on
    extra = on - off
    assert all("FillFunctor<long>" in n for n in extra)
    assert sum(extra.values()) == 2 * (len(advect.PHASES) - 2)


def _graph_case(card):
    mesh, sol, dev = card
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(12, 12), lat_range=(-70, 70), lon_range=(-175, 175)))
    cells = mtt.CellSearch(mesh).query(seeds)
    cells[[3, 50]] = -1                                  # dead lanes
    return mesh, sol, seeds, cells


def _same_bits(a, b):
    bits = lambda t: t if t.dtype == torch.bool else t.view(torch.uint8)
    return torch.equal(bits(a), bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("use_window", [True, False], ids=["k3", "k1"])
@pytest.mark.parametrize("direction", ["FORWARD", "BACKWARD"])
@pytest.mark.parametrize("fail_mode", ["ZERO", "FREEZE"])
def test_graphed_streamline_equals_eager_bit_for_bit(card, dtype, use_window,
                                                     direction, fail_mode,
                                                     monkeypatch):
    """A streamline whose steps replay a captured CUDA graph (the default
    on the card) equals the eager loop's bit for bit: points, velocities,
    final state and window misses; each request counts the same launches
    (kernels.launches.* and kernels.f64_launches.*), and the graphed one
    its replayed steps."""
    from mops_tpu_torch.utils.timer import TimerManager
    mgr = TimerManager.instance()
    mesh, sol, seeds, cells = _graph_case(card)
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 15, record_t=1800,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32),
        direction=getattr(mtt.CalcDirection, direction),
        fail_mode=getattr(mtt.FailMode, fail_mode))
    monkeypatch.setattr(advect, "WINDOW_LAYERS", W)
    runs, counts = {}, {}
    for graph in (False, None):
        with mgr.request("api.test"):
            runs[graph] = mtt.run_advection(mesh, sol, seeds, cells, cfg,
                                            dtype=dtype, use_window=use_window,
                                            graph=graph)
        rid = [s for s in mgr.spans() if s.name == "api.test"][-1].request
        counts[graph] = {k: n for k, n in mgr.counters()[rid].items()
                         if k.startswith((sk.LAUNCHES, sk.F64_LAUNCHES,
                                          "advect.graph_steps"))}
    for name in ("points", "velocities", "final_position", "final_depth",
                 "final_cell", "alive", "window_misses",
                 "window_clamp_misses"):
        a, b = getattr(runs[False], name), getattr(runs[None], name)
        assert (a is None) == (b is None) == (name.startswith("window")
                                              and not use_window), name
        assert a is None or _same_bits(a, b), name
    replayed = cfg.n_steps - advect.GRAPH_WARM_STEPS
    assert counts[False].pop("advect.graph_steps") == 0
    assert counts[None].pop("advect.graph_steps") == replayed
    key = "k3" if use_window else "k1"
    launches = {sk.LAUNCHES + key: cfg.n_steps}
    if use_window:
        launches[sk.LAUNCHES + "k3 repair"] = cfg.n_steps
    if dtype == torch.float64:
        launches.update({sk.F64_LAUNCHES + k[len(sk.LAUNCHES):]: n
                         for k, n in launches.items()})
    assert counts[False] == counts[None] == launches


@pytest.mark.cuda
def test_successive_graphed_requests_do_not_share_storage(card, monkeypatch):
    """Two graphed requests' RawTrajectories share no storage, and the
    first's values survive the second's replays."""
    from mops_tpu_torch.utils.timer import TimerManager
    mesh, sol, seeds, cells = _graph_case(card)
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 15, record_t=1800,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32))
    fields = lambda raw: {f.name: getattr(raw, f.name)
                          for f in dataclasses.fields(raw)
                          if getattr(raw, f.name) is not None}
    monkeypatch.setattr(advect, "WINDOW_LAYERS", W)
    first = mtt.run_advection(mesh, sol, seeds, cells, cfg)
    kept = {k: v.clone() for k, v in fields(first).items()}
    replayed = TimerManager.instance().counter("advect.graph_steps")
    second = mtt.run_advection(mesh, sol, seeds[::-1].copy(),
                               cells[::-1].copy(), cfg)
    assert TimerManager.instance().counter("advect.graph_steps") > replayed

    def spans(raw):
        return [(t.untyped_storage().data_ptr(),
                 t.untyped_storage().data_ptr() + t.untyped_storage().nbytes())
                for t in fields(raw).values()]
    for a0, a1 in spans(first):
        for b0, b1 in spans(second):
            assert a1 <= b0 or b1 <= a0
    for k, v in kept.items():
        assert _same_bits(getattr(first, k), v), k
    assert not _same_bits(first.points, second.points)


@pytest.mark.cuda
def test_graphed_detail_keeps_the_phases_and_the_kernels(card, monkeypatch):
    """A traced (detail) graphed request still keeps the five PHASES spans
    with stream time, and the profiler sees the replayed kernels: the
    same device kernels, name for name, as the eager loop launches, but
    torch's bookkeeping of each capture (the graph adds besides the
    state's copy-back, a copy a field a step)."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mops_tpu_torch.utils.timer import TimerManager
    mgr = TimerManager.instance()
    mesh, sol, seeds, cells = _graph_case(card)
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 15, record_t=1800,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32))
    monkeypatch.setattr(advect, "WINDOW_LAYERS", W)
    kernels = {}
    for graph in (False, None, False, None):          # the first two warm
        mgr.reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with mgr.request("api.test"):
                assert mgr.detail()
                mtt.run_advection(mesh, sol, seeds, cells, cfg, graph=graph)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        kernels[graph] = collections.Counter(
            n for n in names if not n.startswith(("Memcpy", "Memset")))
        phases = [s for s in mgr.spans() if s.name in advect.PHASES]
        assert [s.name for s in phases] == list(advect.PHASES)
        assert all(s.device_ms > 0 for s in phases)
        rid = [s for s in mgr.spans() if s.name == "api.test"][-1].request
        counts = mgr.counters()[rid]
        assert counts["advect.steps"] == cfg.n_steps
        assert counts["advect.graph_steps"] == (
            0 if graph is False else cfg.n_steps - advect.GRAPH_WARM_STEPS)
    # torch fills two int64 scalars of its generator's state at each
    # capture: a graph a phase but the record's
    extra = kernels[None] - kernels[False]
    assert not kernels[False] - kernels[None]
    assert all("FillFunctor<long>" in n for n in extra)
    assert sum(extra.values()) == 2 * (len(advect.PHASES) - 1)
    assert sum(n for k, n in kernels[None].items()
               if "window_streamline_kernel" in k) == cfg.n_steps


@pytest.mark.cuda
def test_graphed_agent_job_equals_eager_with_one_capture(card, monkeypatch):
    """The agent's default streamline job's shapes (the 56 seeds of its
    8 x 8 grid at 10 m, a one-minute RK4 step, a record every six minutes)
    at fp64 over 300 steps: the graphed loop's lines equal the eager
    loop's bit for bit; the graphed request keeps one advect.capture span
    and counts one captured graph, the eager one neither."""
    from mops_tpu_torch.agent.task_templates import \
        DEFAULT_STREAMLINE_CONFIG as agent
    from mops_tpu_torch.utils.timer import TimerManager
    mgr = TimerManager.instance()
    mesh, sol, dev = card
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=tuple(agent["grid"]), lat_range=tuple(agent["lat_range"]),
        lon_range=tuple(agent["lon_range"]), depth=agent["fixed_depth"]))
    assert len(seeds) == 56
    cells = mtt.CellSearch(mesh).query(seeds)
    cfg = mtt.TrajectorySettings(
        delta_t=agent["delta_minutes"] * 60, simulation_duration=300 * 60,
        record_t=agent["record_every_minutes"] * 60,
        depth=agent["fixed_depth"], fail_mode=mtt.FailMode.ZERO)
    monkeypatch.setattr(advect, "WINDOW_LAYERS", W)
    runs, counts, captures = {}, {}, {}
    for graph in (False, None):
        with mgr.request("api.test"):
            runs[graph] = mtt.run_advection(mesh, sol, seeds, cells, cfg,
                                            dtype=torch.float64, graph=graph)
        assert advect.LAST_RESOLVED["kernel"] == "k3"
        rid = [s for s in mgr.spans() if s.name == "api.test"][-1].request
        counts[graph] = mgr.counters()[rid]
        captures[graph] = [s for s in mgr.spans() if s.request == rid
                           and s.name == "advect.capture"]
    for name in ("points", "velocities", "final_position", "final_depth",
                 "final_cell", "alive", "window_misses",
                 "window_clamp_misses"):
        assert _same_bits(getattr(runs[False], name),
                          getattr(runs[None], name)), name
    assert counts[None]["advect.captures"] == len(captures[None]) == 1
    assert "advect.captures" not in counts[False] and not captures[False]
    assert counts[None]["advect.graph_steps"] == \
        cfg.n_steps - advect.GRAPH_WARM_STEPS
    assert counts[None][sk.F64_LAUNCHES + "k3"] == cfg.n_steps
