"""The least bytes one fused step must move, and the operations it does, at
a job's start inputs: a frozen copy of the count the port keeps beside its
kernels, on the benchmark's own tables (reference.Mesh, reference.Snapshot).

Bytes: each input read once and each output written once.  Vertex rows that
several particles share count once: xyz (from the front table) and the ztop
of every vertex an alive particle's cell uses, in each snapshot (the whole
column, or with a window of W layers the window's layers at the start
position's window start plus the surface and bottom values), plus the
velocity (3), vertical velocity (1) and attribute values of each distinct
(vertex, layer) pair that the layers above and below the particle's depth
pick; pos, depth, nv and the nv vertex ids (and the window start); the
outputs.  The layers are those at the start position, so this is a lower
bound.  Operations: the leading terms of the kernel's loops over four RK4
stages (geometry ~85 per vertex; per snapshot the profile 2 nv (L or W) and
the picks 2 nv (8 + 2A)).
"""

from __future__ import annotations

import torch

from . import reference as ref

CHUNK = 1 << 18


def window_starts(layer, n_layers: int, n_window: int):
    """Window start clip(layer - max(1, W / 2 - 1), 0, L - W)."""
    return (layer - max(1, n_window // 2 - 1)).clamp(0, n_layers - n_window)


def step_cost(mesh: ref.Mesh, snaps, seeds, cells, depths, n_attrs: int = 0,
              n_window: int = 0, size: int = 4):
    """(bytes, operations) of one step of particles at ``seeds`` (N, 3) in
    ``cells`` at ``depths`` (m, positive down) over ``snaps`` (one: a
    streamline; two: a pathline), for values of ``size`` bytes."""
    dev = mesh.cell_xyz.device
    pathline = len(snaps) == 2
    L = snaps[0].ztop.shape[1]
    n = len(seeds)
    if n == 0:
        return 0, 0.0

    def union(acc, new):
        new = torch.unique(new)
        return new if acc is None else torch.unique(torch.cat([acc, new]))

    verts, keys, zkeys = None, [None] * len(snaps), [None] * len(snaps)
    ops, nv_sum = 0.0, 0
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        cell = torch.as_tensor(cells[a:b], device=dev).long()
        alive = (cell >= 0) & (cell < mesh.n_cells)
        vids, nv_cell, _ = ref.cell_vertices(mesh,
                                             cell.clamp(0, mesh.n_cells - 1))
        nv = torch.where(alive, nv_cell, 0)
        valid = torch.arange(vids.shape[1], device=dev)[None, :] \
            < nv[:, None]
        verts = union(verts, vids[valid])
        pos = torch.as_tensor(seeds[a:b], device=dev, dtype=torch.float64)
        dn = -torch.as_tensor(depths[a:b], device=dev).to(torch.float64)
        w = ref.wachspress(pos, mesh.vertex_xyz[vids], nv_cell)
        nvd = nv.double()
        nv_sum += int(nv.sum())
        lane_ops = 85 * nvd
        if n_window:
            z = ref.clamp_profile(torch.einsum(
                "nk,nkl->nl", w, snaps[0].ztop.double()[vids]))
            s = window_starts(ref.layer_binary(z, dn), L, n_window)
            lw = s[:, None, None] + torch.arange(n_window, device=dev)
        for j, snap in enumerate(snaps):
            z = ref.clamp_profile(torch.einsum("nk,nkl->nl", w,
                                               snap.ztop.double()[vids]))
            layer = ref.layer_linear(z, dn)[0] if pathline \
                else ref.layer_binary(z, dn)
            keys[j] = union(keys[j], torch.cat(
                [(vids * L + (layer - 1)[:, None])[valid],
                 (vids * L + layer[:, None])[valid]]))
            if n_window:
                zkeys[j] = union(zkeys[j], (vids[:, :, None] * L + lw)[valid])
            lane_ops = lane_ops + 2 * nvd * ((n_window or L) + 8 + 2 * n_attrs)
        ops += 4 * float(lane_ops.sum())
    n_vert = int(verts.numel())
    nbytes = n_vert * 3 * size
    for j in range(len(snaps)):
        nbytes += (int(zkeys[j].numel()) + 2 * n_vert if n_window
                   else n_vert * L) * size
        nbytes += int(keys[j].numel()) * (3 + 1 + n_attrs) * size
    nbytes += n * (4 * size + 4) + 4 * nv_sum                    # inputs
    nbytes += n * (7 * size + 1 + (3 * size if n_attrs else 0))  # outputs
    if n_window:
        nbytes += n * (4 + 4 + 1)                # start in; layer, miss out
    return nbytes, ops
