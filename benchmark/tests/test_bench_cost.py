"""The step's least bytes (cost.step_cost) against a direct count, particle
by particle, at a tiny size."""

import numpy as np
import pytest
import torch

from benchmark import cost, fields, meshgen, reference, traffic


@pytest.fixture(scope="module")
def tiny():
    arrays = meshgen.build(600, 10, seed=3, jitter=0.05)
    mesh = reference.mesh_from_arrays(arrays, "cpu")
    params = [fields.draw({"omega": 3e-7, "omega_decay": 1.0,
                           "bathymetry_amp": 0.5, "shelf_lon": 0.3,
                           "w_scale": 1e-3}, np.random.default_rng(0)),
              fields.draw({"omega": 3.6e-7}, np.random.default_rng(1))]
    snaps = [reference.preprocess(mesh, fields.solid_body(mesh.cell_xyz, 10,
                                                          p)) for p in params]
    rng = np.random.default_rng(5)
    v = rng.normal(size=(50, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) \
        * traffic.EARTH_RADIUS
    depths = rng.uniform(10, 3000, 50).astype(np.float32)
    return mesh, snaps, seeds, reference.nearest_cells(mesh, seeds), depths


def direct(mesh, snaps, seeds, cells, depths, n_attrs, W, size):
    """The same count with Python sets, one particle at a time."""
    L = snaps[0].ztop.shape[1]
    verts, keys = set(), [set() for _ in snaps]
    zkeys = [set() for _ in snaps]
    nv_sum = 0
    for p, c, d in zip(seeds, cells, depths):
        vids, nv, _ = reference.cell_vertices(mesh, torch.tensor([c]))
        nv = int(nv[0])
        vs = [int(x) for x in vids[0, :nv]]
        nv_sum += nv
        verts |= set(vs)
        pos = torch.tensor(p)[None]
        dn = -torch.tensor([float(d)], dtype=torch.float64)
        w = reference.wachspress(pos, mesh.vertex_xyz[vids], torch.tensor([nv]))
        start = None
        for j, s in enumerate(snaps):
            z = reference.clamp_profile(torch.einsum(
                "nk,nkl->nl", w, s.ztop[vids]))
            layer = int((reference.layer_linear(z, dn)[0] if len(snaps) == 2
                         else reference.layer_binary(z, dn))[0])
            if j == 0 and W:
                z0 = reference.clamp_profile(torch.einsum(
                    "nk,nkl->nl", w, snaps[0].ztop[vids]))
                lay0 = int(reference.layer_binary(z0, dn)[0])
                start = min(max(lay0 - max(1, W // 2 - 1), 0), L - W)
            for v in vs:
                keys[j] |= {(v, layer - 1), (v, layer)}
                if W:
                    zkeys[j] |= {(v, start + i) for i in range(W)}
    n = len(seeds)
    total = len(verts) * 3 * size
    for j in range(len(snaps)):
        total += (len(zkeys[j]) + 2 * len(verts) if W
                  else len(verts) * L) * size
        total += len(keys[j]) * (3 + 1 + n_attrs) * size
    total += n * (4 * size + 4) + 4 * nv_sum
    total += n * (7 * size + 1 + (3 * size if n_attrs else 0))
    if W:
        total += n * 9
    return total


@pytest.mark.parametrize("pathline, W", [(False, 0), (False, 8),
                                         (True, 0), (True, 8)])
def test_step_bytes_match_a_direct_count(tiny, pathline, W):
    mesh, snaps, seeds, cells, depths = tiny
    use = snaps if pathline else snaps[:1]
    n_attrs = 2 if pathline else 0
    got, ops = cost.step_cost(mesh, use, seeds, cells, depths, n_attrs, W, 4)
    assert got == direct(mesh, use, seeds, cells, depths, n_attrs, W, 4)
    assert ops > 0


def test_chunks_do_not_change_the_count(tiny, monkeypatch):
    mesh, snaps, seeds, cells, depths = tiny
    whole = cost.step_cost(mesh, snaps, seeds, cells, depths, 2, 8)
    monkeypatch.setattr(cost, "CHUNK", 7)
    assert cost.step_cost(mesh, snaps, seeds, cells, depths, 2, 8) == whole
