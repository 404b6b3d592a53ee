"""MPAS-Ocean mesh container: struct-of-tensors, 0-based, rectangular-padded.

Mirror of mops_tpu.mesh.MPASMesh: all index tensors are normalized once at
ingest to 0-based int32 with -1 marking missing entries, so every downstream
op is a plain gather.  Any raw MPAS id outside [1, n] (0 = missing, or the
n+1 "land" sentinel some meshes use) becomes -1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _normalize_connectivity(raw: np.ndarray, n_valid_targets: int) -> np.ndarray:
    """1-based raw MPAS connectivity -> 0-based int64->int32 with -1 sentinel."""
    arr = np.asarray(raw, dtype=np.int64)
    out = arr - 1
    out[(arr < 1) | (arr > n_valid_targets)] = -1
    return out.astype(np.int32)


_FLOAT_FIELDS = ("cell_xyz", "vertex_xyz", "edge_xyz", "ref_bottom_depth")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  The entry points default to
    "cuda"; the CPU runs only when the caller asks for it (device="cpu"),
    and a CUDA request without a card raises instead of falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' to "
                           "run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class MPASMesh:
    """Static horizontal mesh; sizes derive from shapes.

    Shapes:
      cell_xyz:          (nCells, 3)   float
      vertex_xyz:        (nVertices, 3)
      edge_xyz:          (nEdges, 3)
      n_edges_on_cell:   (nCells,)     int32
      vertices_on_cell:  (nCells, maxEdges) int32, -1 padded
      cells_on_cell:     (nCells, maxEdges) int32, -1 padded/missing
      cells_on_vertex:   (nVertices, 3)     int32, -1 missing
      edges_on_cell:     (nCells, maxEdges) int32, -1 padded
      cells_on_edge:     (nEdges, 2)        int32, -1 missing
      vertices_on_edge:  (nEdges, 2)        int32, -1 missing
      ref_bottom_depth:  (nVertLevels,) or None
    """

    cell_xyz: torch.Tensor
    vertex_xyz: torch.Tensor
    edge_xyz: torch.Tensor
    n_edges_on_cell: torch.Tensor
    vertices_on_cell: torch.Tensor
    cells_on_cell: torch.Tensor
    cells_on_vertex: torch.Tensor
    edges_on_cell: torch.Tensor
    cells_on_edge: torch.Tensor
    vertices_on_edge: torch.Tensor
    ref_bottom_depth: Optional[torch.Tensor] = None
    name: str = "mesh"

    @property
    def n_cells(self) -> int:
        return self.cell_xyz.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.vertex_xyz.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_xyz.shape[0]

    @property
    def max_edges(self) -> int:
        return self.vertices_on_cell.shape[1]

    @property
    def device(self) -> torch.device:
        return self.cell_xyz.device

    @property
    def dtype(self) -> torch.dtype:
        return self.cell_xyz.dtype

    def validate(self) -> None:
        """Structural invariants (mirrors MPASOGrid::checkAttribute,
        reference src/Core/MPASOGrid.cpp:516-599, as mops_tpu's
        MPASMesh.validate): raises AssertionError where one fails, and
        ValueError (numpy's) on a mesh without cells or vertices."""
        nc, nv, me = self.n_cells, self.n_vertices, self.max_edges

        def check(ok, what):
            if not ok:
                raise AssertionError(f"mesh invariant failed: {what}")

        check(tuple(self.n_edges_on_cell.shape) == (nc,),
              "n_edges_on_cell is (nCells,)")
        check(tuple(self.vertices_on_cell.shape) == (nc, me),
              "vertices_on_cell is (nCells, maxEdges)")
        check(tuple(self.cells_on_cell.shape) == (nc, me),
              "cells_on_cell is (nCells, maxEdges)")
        check(tuple(self.cells_on_vertex.shape) == (nv, 3),
              "cells_on_vertex is (nVertices, 3)")
        voc = self.vertices_on_cell.cpu().numpy()
        check(voc.max() < nv and voc.min() >= -1,
              "vertices_on_cell ids in [-1, nVertices)")
        cov = self.cells_on_vertex.cpu().numpy()
        check(cov.max() < nc and cov.min() >= -1,
              "cells_on_vertex ids in [-1, nCells)")
        neoc = self.n_edges_on_cell.cpu().numpy()
        check((neoc >= 1).all() and (neoc <= me).all(),
              "1 <= n_edges_on_cell <= maxEdges")

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "MPASMesh":
        """Move every tensor to ``device``; cast the float tensors to
        ``dtype`` (index tensors stay int32)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = v.to(device=device,
                         dtype=dtype if f.name in _FLOAT_FIELDS else None)
            out[f.name] = v
        return MPASMesh(**out)

    @classmethod
    def from_raw(cls,
                 cell_xyz: np.ndarray,
                 vertex_xyz: np.ndarray,
                 edge_xyz: np.ndarray,
                 n_edges_on_cell: np.ndarray,
                 vertices_on_cell_1based: np.ndarray,
                 cells_on_cell_1based: np.ndarray,
                 cells_on_vertex_1based: np.ndarray,
                 edges_on_cell_1based: np.ndarray,
                 cells_on_edge_1based: np.ndarray,
                 vertices_on_edge_1based: np.ndarray,
                 ref_bottom_depth: Optional[np.ndarray] = None,
                 name: str = "mesh",
                 dtype=np.float64) -> "MPASMesh":
        """Build from raw (1-based, as stored in MPAS NetCDF) arrays."""
        n_cells = int(np.asarray(cell_xyz).shape[0])
        n_vertices = int(np.asarray(vertex_xyz).shape[0])
        n_edges = int(np.asarray(edge_xyz).shape[0])
        me = int(np.asarray(vertices_on_cell_1based).reshape(n_cells, -1).shape[1])
        t = torch.from_numpy
        return cls(
            cell_xyz=t(np.asarray(cell_xyz, dtype=dtype).reshape(n_cells, 3)),
            vertex_xyz=t(np.asarray(vertex_xyz, dtype=dtype).reshape(n_vertices, 3)),
            edge_xyz=t(np.asarray(edge_xyz, dtype=dtype).reshape(n_edges, 3)),
            n_edges_on_cell=t(np.asarray(n_edges_on_cell, dtype=np.int32)
                              .reshape(n_cells)),
            vertices_on_cell=t(_normalize_connectivity(
                np.asarray(vertices_on_cell_1based).reshape(n_cells, me), n_vertices)),
            cells_on_cell=t(_normalize_connectivity(
                np.asarray(cells_on_cell_1based).reshape(n_cells, me), n_cells)),
            cells_on_vertex=t(_normalize_connectivity(
                np.asarray(cells_on_vertex_1based).reshape(n_vertices, 3), n_cells)),
            edges_on_cell=t(_normalize_connectivity(
                np.asarray(edges_on_cell_1based).reshape(n_cells, me), n_edges)),
            cells_on_edge=t(_normalize_connectivity(
                np.asarray(cells_on_edge_1based).reshape(n_edges, 2), n_cells)),
            vertices_on_edge=t(_normalize_connectivity(
                np.asarray(vertices_on_edge_1based).reshape(n_edges, 2), n_vertices)),
            ref_bottom_depth=(None if ref_bottom_depth is None
                              else t(np.asarray(ref_bottom_depth, dtype=dtype))),
            name=name,
        )
