"""Mesh domain decomposition: spatial cell partitions with halo rings
(the port's copy of mops_tpu.parallel.decompose, plain numpy).

The reference requires the whole mesh + all per-layer vertex fields resident
on one device (its only multi-process mode duplicates identical work per MPI
rank, reference CLI/main.cpp:58-66).  To scale past single-chip HBM, cells are
partitioned into contiguous longitude sectors (balanced by cell count), each
shard carrying a halo of `halo_rings` neighbor rings; particles are owned by
their cell's shard and migrate between shards as they cross partition
boundaries (see migrate.py).

All outputs are rectangular (P, n_local_max, ...) numpy stacks; migrate.py
moves shard p's slices to its device.  The mesh and fields are read as
numpy (tensors on any device, or arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..mesh import MPASMesh
from ..solution import SolutionFields


def _np(a, dtype=None) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


@dataclasses.dataclass
class DecomposedMesh:
    """Per-shard local mesh + solution tables, stacked on a leading P axis.

    Index conventions: local cell/vertex ids within each shard; -1 = missing
    (beyond halo).  ``owner`` maps local cell -> owning shard;
    ``cell_l2g`` maps local -> global; ``cell_g2l[p]`` maps global -> local
    on shard p (-1 if not resident).
    """

    # local mesh tables (P, nLC, ...) / (P, nLV, ...)
    cell_xyz: np.ndarray
    vertex_xyz: np.ndarray
    n_edges_on_cell: np.ndarray
    vertices_on_cell: np.ndarray
    cells_on_cell: np.ndarray
    # ownership / id maps
    owner: np.ndarray              # (P, nLC) int32, shard owning each local cell
    cell_l2g: np.ndarray           # (P, nLC) int32
    cell_g2l: np.ndarray           # (P, nCells) int32
    n_local_cells: np.ndarray      # (P,) real (unpadded) local cell counts
    # local solution tables (P, nLV, L...) per field
    vertex_ztop: np.ndarray
    vertex_velocity: np.ndarray
    vertex_vert_velocity: np.ndarray
    # optional second snapshot (pathline) + stacked named attributes
    vertex_ztop_b: Optional[np.ndarray] = None
    vertex_velocity_b: Optional[np.ndarray] = None
    vertex_vert_velocity_b: Optional[np.ndarray] = None
    vertex_attrs: Optional[np.ndarray] = None      # (P, nLV, L, A)
    vertex_attrs_b: Optional[np.ndarray] = None

    @property
    def n_shards(self) -> int:
        return self.cell_xyz.shape[0]


def partition_cells(mesh: MPASMesh, n_shards: int) -> np.ndarray:
    """Global cell -> shard assignment: contiguous longitude sectors balanced
    by cell count (minimal boundary for a 1-D shard topology)."""
    cx = _np(mesh.cell_xyz)
    lon = np.arctan2(cx[:, 1], cx[:, 0])
    order = np.argsort(lon, kind="stable")
    owner = np.empty(mesh.n_cells, dtype=np.int32)
    bounds = np.linspace(0, mesh.n_cells, n_shards + 1).astype(int)
    for p in range(n_shards):
        owner[order[bounds[p]:bounds[p + 1]]] = p
    return owner


def decompose(mesh: MPASMesh, sol: SolutionFields, n_shards: int,
              halo_rings: int = 1, dtype=np.float32,
              back: Optional[SolutionFields] = None,
              attrs_front: Optional[np.ndarray] = None,
              attrs_back: Optional[np.ndarray] = None) -> DecomposedMesh:
    """Build per-shard local tables with `halo_rings` rings of ghost cells.

    ``back`` adds the second-snapshot tables for pathline; ``attrs_front`` /
    ``attrs_back`` are stacked (nV, L, A) named-attribute tables
    (advect.stacked_vertex_attrs, as numpy)."""
    owner_g = partition_cells(mesh, n_shards)
    coc = _np(mesh.cells_on_cell)
    voc = _np(mesh.vertices_on_cell)
    neoc = _np(mesh.n_edges_on_cell)
    cxyz = _np(mesh.cell_xyz, dtype=dtype)
    vxyz = _np(mesh.vertex_xyz, dtype=dtype)

    # Vectorized halo expansion: per shard, a boolean frontier grown one ring
    # at a time through the padded cellsOnCell table (no Python-set loops, so
    # million-cell meshes decompose in O(P * rings * nnz) numpy time).
    lane_valid = np.arange(coc.shape[1])[None, :] < neoc[:, None]
    coc_valid = np.where(lane_valid & (coc >= 0), coc, -1)
    local_cells = []
    for p in range(n_shards):
        member = owner_g == p
        frontier = member
        for _ in range(halo_rings):
            nbr = coc_valid[frontier].ravel()
            nbr = nbr[nbr >= 0]
            new = np.zeros(mesh.n_cells, dtype=bool)
            new[nbr] = True
            new &= ~member
            if not new.any():
                break
            member = member | new
            frontier = new
        local_cells.append(np.nonzero(member)[0].astype(np.int64))

    n_lc = max(len(c) for c in local_cells)
    K = mesh.max_edges

    P = n_shards
    out = dict(
        cell_xyz=np.zeros((P, n_lc, 3), dtype=dtype),
        n_edges_on_cell=np.ones((P, n_lc), dtype=np.int32),
        vertices_on_cell=np.full((P, n_lc, K), -1, dtype=np.int32),
        cells_on_cell=np.full((P, n_lc, K), -1, dtype=np.int32),
        owner=np.full((P, n_lc), -1, dtype=np.int32),
        cell_l2g=np.full((P, n_lc), -1, dtype=np.int32),
        cell_g2l=np.full((P, mesh.n_cells), -1, dtype=np.int32),
        n_local_cells=np.zeros(P, dtype=np.int32),
    )

    # every per-vertex table, read as numpy once
    vtabs = {"vertex_xyz": vxyz,
             "vertex_ztop": _np(sol.vertex_ztop, dtype=dtype),
             "vertex_velocity": _np(sol.vertex_velocity, dtype=dtype),
             "vertex_vert_velocity": _np(sol.vertex_vert_velocity,
                                         dtype=dtype)}
    if back is not None:
        vtabs.update(
            vertex_ztop_b=_np(back.vertex_ztop, dtype=dtype),
            vertex_velocity_b=_np(back.vertex_velocity, dtype=dtype),
            vertex_vert_velocity_b=_np(back.vertex_vert_velocity,
                                       dtype=dtype))
    if attrs_front is not None:
        vtabs["vertex_attrs"] = _np(attrs_front, dtype=dtype)
    if attrs_back is not None:
        vtabs["vertex_attrs_b"] = _np(attrs_back, dtype=dtype)

    vert_sets = []
    for p in range(P):
        vids = voc[local_cells[p]]
        vert_sets.append(np.unique(vids[vids >= 0]))
    n_lv = max(len(v) for v in vert_sets)
    out.update({k: np.zeros((P, n_lv) + v.shape[1:], dtype=dtype)
                for k, v in vtabs.items()})

    for p in range(P):
        cells = local_cells[p]
        n = len(cells)
        out["n_local_cells"][p] = n
        g2l_c = np.full(mesh.n_cells, -1, dtype=np.int32)
        g2l_c[cells] = np.arange(n, dtype=np.int32)
        out["cell_g2l"][p] = g2l_c
        out["cell_l2g"][p, :n] = cells
        out["owner"][p, :n] = owner_g[cells]
        out["cell_xyz"][p, :n] = cxyz[cells]
        out["n_edges_on_cell"][p, :n] = neoc[cells]

        verts = vert_sets[p]
        g2l_v = np.full(mesh.n_vertices, -1, dtype=np.int32)
        g2l_v[verts] = np.arange(len(verts), dtype=np.int32)
        for k, v in vtabs.items():
            out[k][p, :len(verts)] = v[verts]

        loc_voc = voc[cells]
        out["vertices_on_cell"][p, :n] = np.where(
            loc_voc >= 0, g2l_v[np.clip(loc_voc, 0, None)], -1)
        loc_coc = coc[cells]
        out["cells_on_cell"][p, :n] = np.where(
            loc_coc >= 0, g2l_c[np.clip(loc_coc, 0, None)], -1)

    return DecomposedMesh(**out)
