"""Particle -> cell assignment (mirror of mops_tpu.cellsearch).

The reference builds a nanoflann KD-tree over cell centers and queries it on
the host at seed time and per remap pixel (src/Core/MPASOGrid.cpp:247-313).
CellSearch answers the same exact-L2 1-NN queries on the host with the
native bucket grid (native/, g++) or, without a compiler, scipy's
cKDTree; BucketGrid is the search on the device: a coarse lat-lon bucket
table built once on the host, queried with torch ops.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle

import numpy as np
import torch
from scipy.spatial import cKDTree

from . import native
from .advect import _relocate_packed, build_reloc_xyz
from .mesh import MPASMesh


class CellSearch:
    """Exact 1-NN cell lookup over cell centers, on the host.

    Prefers the native bucket grid (``prefer_native``, as mops_tpu does),
    and takes scipy's cKDTree where the native library does not build
    (no compiler): both give the exact nearest cell, nanoflann's answer
    (reference src/Core/MPASOGrid.cpp:247-313).  ``backend`` says which
    ("native" or "kdtree").  With ``cache_dir`` the cKDTree is pickled
    there and loaded on the next build over the same cells, like the
    reference's KDTree.bin (:247-285)."""

    def __init__(self, mesh: MPASMesh, prefer_native: bool = True,
                 cache_dir=None):
        xyz = mesh.cell_xyz.detach().cpu().double().numpy()
        self._native = native.NativeCellSearch(xyz) \
            if prefer_native and native.load() is not None else None
        self.backend = "kdtree" if self._native is None else "native"
        self._tree = None if self._native is not None \
            else _load_or_build_tree(xyz, cache_dir)

    def query(self, points) -> np.ndarray:
        """(N, 3) XYZ -> (N,) nearest cell ids (int32).

        Equivalent to MPASOGrid::searchKDT + MPASOField::calcInWhichCells
        (reference src/Core/MPASOField.cpp:23-34)."""
        if hasattr(points, "detach"):
            points = points.detach().cpu().numpy()
        pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        if self._native is not None:
            return self._native.query(pts)
        _, idx = self._tree.query(pts, k=1)
        return idx.astype(np.int32)


def _load_or_build_tree(xyz: np.ndarray, cache_dir) -> cKDTree:
    """cKDTree over ``xyz``, loaded from (or pickled into) ``cache_dir``
    under a key of the cells' shape and a sample of them
    (mops_tpu/cellsearch.py:46-73); the build is the slow part at
    multi-million-cell meshes."""
    if not cache_dir:
        return cKDTree(xyz)
    key = hashlib.sha1(np.ascontiguousarray(xyz[::max(1, len(xyz) // 64)])
                       .tobytes() + str(xyz.shape).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"kdtree_{key}.pkl")
    if os.path.exists(path):
        # a file this class wrote
        with open(path, "rb") as f:
            return pickle.load(f)
    tree = cKDTree(xyz)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(tree, f)
    os.replace(tmp, path)
    return tree


@dataclasses.dataclass(frozen=True)
class BucketGrid:
    """Coarse lat-lon bucket grid for a cell search on the device.

    Built once on the host: every bucket stores up to ``depth`` candidate
    cells covering it (cells whose center falls in the bucket or its 8
    neighbours).  Query: bucket lookup -> argmin distance over the
    candidates -> ``refine_steps`` neighbour-walk passes (the advection's
    relocation).  For any point whose true nearest cell center lies within
    the bucket neighbourhood this is exact; the walk fixes stragglers near
    bucket borders.
    """

    table: torch.Tensor   # (n_lat * n_lon, depth) int32 candidates, -1 pad
    n_lat: int
    n_lon: int

    @staticmethod
    def build(mesh: MPASMesh, n_lat: int = 0, n_lon: int = 0,
              depth: int = 24) -> "BucketGrid":
        """The table on the mesh's device (the same table as
        mops_tpu.cellsearch.BucketGrid.build)."""
        cx = mesh.cell_xyz.detach().cpu().double().numpy()
        if n_lat <= 0:
            # ~20 cells per bucket so no 3x3 neighbourhood is ever empty
            n_lat = max(4, int(np.sqrt(cx.shape[0] / 20)))
            n_lon = 2 * n_lat
        r = np.linalg.norm(cx, axis=1)
        lat = np.arcsin(np.clip(cx[:, 2] / r, -1, 1))
        lon = np.arctan2(cx[:, 1], cx[:, 0])
        li = np.clip(((lat + np.pi / 2) / np.pi * n_lat).astype(int), 0,
                     n_lat - 1)
        lj = np.clip(((lon + np.pi) / (2 * np.pi) * n_lon).astype(int), 0,
                     n_lon - 1)
        # (bucket, cell) pairs of each cell's 3x3 neighbourhood, in cell
        # order within a bucket
        di, dj = np.meshgrid([-1, 0, 1], [-1, 0, 1], indexing="ij")
        bi = li[:, None] + di.ravel()[None, :]
        bj = (lj[:, None] + dj.ravel()[None, :]) % n_lon
        keep = (bi >= 0) & (bi < n_lat)
        bucket = (bi * n_lon + bj)[keep]
        cell = np.broadcast_to(np.arange(cx.shape[0])[:, None],
                               bi.shape)[keep]
        order = np.argsort(bucket, kind="stable")
        bucket, cell = bucket[order], cell[order]
        counts = np.bincount(bucket, minlength=n_lat * n_lon)
        depth = max(depth, int(counts.max()))
        rank = np.arange(len(bucket)) - np.repeat(
            np.cumsum(counts) - counts, counts)
        table = np.full((n_lat * n_lon, depth), -1, dtype=np.int32)
        table[bucket, rank] = cell
        return BucketGrid(table=torch.as_tensor(table, device=mesh.device),
                          n_lat=n_lat, n_lon=n_lon)

    def query(self, mesh: MPASMesh, points: torch.Tensor,
              refine_steps: int = 2) -> torch.Tensor:
        """(N, 3) points on the mesh's device -> (N,) int32 cell ids."""
        p = points
        r = torch.linalg.vector_norm(p, dim=-1)
        lat = torch.arcsin(torch.clamp(p[:, 2] / r, -1, 1))
        lon = torch.arctan2(p[:, 1], p[:, 0])
        li = torch.clamp(((lat + np.pi / 2) / np.pi * self.n_lat).to(
            torch.int32), 0, self.n_lat - 1)
        lj = torch.clamp(((lon + np.pi) / (2 * np.pi) * self.n_lon).to(
            torch.int32), 0, self.n_lon - 1)
        cand = self.table[(li * self.n_lon + lj).long()]      # (N, depth)
        d2 = torch.sum((mesh.cell_xyz[torch.clamp(cand, min=0).long()]
                        - p[:, None, :]) ** 2, dim=-1)
        d2 = torch.where(cand >= 0, d2, float("inf"))
        cell = cand.gather(1, torch.argmin(d2, dim=1)[:, None])[:, 0]
        # neighbour-walk refinement (the advection's relocation move)
        reloc_xyz = build_reloc_xyz(mesh)
        for _ in range(refine_steps):
            cell = _relocate_packed(mesh, reloc_xyz, p, cell)
        return cell
