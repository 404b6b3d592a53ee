"""The fused streamline step of mops_tpu_torch (kernels/stage_kernel.py)
against the JAX Pallas kernel it replaces, run in interpret mode at float64.

Tolerances are test_pallas.py's: positions 1e-6 m, hvel 1e-10 m/s, wvel
1e-12 m/s, ok equal.  On the CPU the wrapper runs the plain version; the
CUDA kernel itself is checked against that version on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mops_tpu as mt
from mops_tpu import advect as jadvect
from mops_tpu.pallas import fused_streamline_step as jax_fused_step
from mops_tpu.pallas import pack_vertex_table as jax_pack
from mops_tpu_torch import advect
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax
from mops_tpu_torch.kernels import stage_kernel
from mops_tpu_torch.kernels.stage_kernel import (fused_streamline_step,
                                                 fused_streamline_step_plain,
                                                 pack_vertex_table)

torch.set_num_threads(1)

DT = 600.0


def _case(mesh, edge_lanes: bool):
    """test_pallas.py's case (256 random seeds at 500 m); with
    ``edge_lanes`` some lanes are moved out of their cell, below the bottom,
    above the surface, or made dead (a NaN position, as a failed Euler
    step leaves it)."""
    rng = np.random.default_rng(5)
    n = 256
    v = rng.normal(size=(n, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mt.EARTH_RADIUS
    cells = mt.CellSearch(mesh).query(seeds)
    depth_neg = np.full(n, -500.0)
    if edge_lanes:
        coc = np.asarray(mesh.cells_on_cell)
        cells[:16] = coc[cells[:16], 0]                  # out of cell
        depth_neg[16:32] = -4500.0                       # below the bottom
        depth_neg[32:40] = 5.0                           # above the surface
        seeds[40:44] = np.nan                            # dead lanes
        depth_neg[44:60] = np.linspace(-4000.0, 0.0, 16)  # on interfaces
    return seeds, cells.astype(np.int32), depth_neg


def _jax_step(mesh, sol, seeds, cells, depth_neg, euler):
    vids, nv, _, _, _ = jadvect._gather_cell_vertices(mesh, jnp.asarray(cells))
    tab = jax_pack(jnp.asarray(mesh.vertex_xyz), sol.vertex_ztop,
                   sol.vertex_velocity, sol.vertex_vert_velocity)
    cols = jnp.moveaxis(tab[vids], 0, -1)                # (K, F, N)
    out = jax_fused_step(jnp.asarray(seeds).T, jnp.asarray(depth_neg)[None],
                         nv[None].astype(jnp.int32), cols,
                         sol.vertex_ztop.shape[1], DT, euler=euler,
                         block=256, interpret=True)
    new_pos, hvel, wvel, ok = (np.asarray(a) for a in out)
    return new_pos.T, hvel.T, wvel[0], ok[0].astype(bool)


def _port_inputs(mesh, sol, seeds, cells, depth_neg, device="cpu",
                 dtype=torch.float64):
    pmesh = mesh_from_jax(mesh).to(device, dtype)
    psol = solution_from_jax(sol).to(device, dtype)
    vids, nv, _ = advect._gather_cell_vertices(
        pmesh, torch.as_tensor(cells, device=device))
    table = pack_vertex_table(pmesh.vertex_xyz, psol.vertex_ztop,
                              psol.vertex_velocity,
                              psol.vertex_vert_velocity)
    pos = torch.as_tensor(seeds, device=device, dtype=dtype)
    dn = torch.as_tensor(depth_neg, device=device, dtype=dtype)
    return pos, dn, nv, vids, table, psol.vertex_ztop.shape[1]


def _assert_step_close(port, ref):
    new_pos, hvel, wvel, ok = (t.cpu().numpy() for t in port)
    np.testing.assert_allclose(new_pos, ref[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(hvel, ref[1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(wvel, ref[2], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ok, ref[3])


@pytest.fixture(scope="module")
def jax_refs(mesh, sol):
    """JAX kernel outputs for both cases, one interpret-mode call (two grid
    blocks) per method, computed on first use."""
    cache = {}

    def get(euler, edge_lanes):
        if euler not in cache:
            cases = [_case(mesh, e) for e in (False, True)]
            both = [np.concatenate(parts) for parts in zip(*cases)]
            out = _jax_step(mesh, sol, *both, euler)
            cache[euler] = [tuple(o[:256] for o in out),
                            tuple(o[256:] for o in out)]
        return cache[euler][int(edge_lanes)]
    return get


@pytest.mark.parametrize("euler", [False, True], ids=["rk4", "euler"])
@pytest.mark.parametrize("edge_lanes", [False, True],
                         ids=["pallas_case", "edge_lanes"])
def test_plain_step_matches_jax_pallas_kernel(mesh, sol, jax_refs, euler,
                                              edge_lanes):
    seeds, cells, depth_neg = _case(mesh, edge_lanes)
    ref = jax_refs(euler, edge_lanes)
    args = _port_inputs(mesh, sol, seeds, cells, depth_neg)
    _assert_step_close(fused_streamline_step_plain(*args, DT, euler=euler), ref)
    if edge_lanes:
        ok = ref[3]
        assert not ok[:16].any() and not ok[40:44].any() and ok[64:].any()


def test_wrapper_takes_the_plain_version_on_cpu(mesh, sol):
    seeds, cells, depth_neg = _case(mesh, True)
    args = _port_inputs(mesh, sol, seeds, cells, depth_neg)
    before = stage_kernel.launch_counts()
    got = fused_streamline_step(*args, DT)
    want = fused_streamline_step_plain(*args, DT)
    assert stage_kernel.launch_counts() == before        # no kernel launch
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_wrapper_rejects_what_the_kernel_does_not_take(mesh, sol):
    seeds, cells, depth_neg = _case(mesh, False)
    pos, dn, nv, vids, table, L = _port_inputs(mesh, sol, seeds, cells,
                                               depth_neg)
    with pytest.raises(TypeError):
        fused_streamline_step(pos, dn, nv, vids.long(), table, L, DT)
    with pytest.raises(TypeError):
        fused_streamline_step(pos, dn.float(), nv, vids, table, L, DT)
    with pytest.raises(ValueError):
        fused_streamline_step(pos, dn, nv, vids, table, L + 1, DT)
    with pytest.raises(ValueError):
        fused_streamline_step(pos.t().contiguous().t(), dn, nv, vids, table,
                              L, DT)
    assert stage_kernel.SOURCE.exists()
