"""A configuration's mesh: a jittered spherical Voronoi tessellation, emitted
as the arrays an MPAS NetCDF mesh file holds (1-based ids, 0 = missing).

A frozen, vectorised copy of the generator the port ships for synthetic
meshes (a Fibonacci lattice jittered by a seeded normal draw, scipy's
SphericalVoronoi, regions oriented counter-clockwise from outside, edges
numbered in order of first appearance, cellsOnVertex the first three cells
in cell order).  The benchmark keeps its own copy so that no program change
can move the dataset.  ``load`` caches the arrays in a fixed directory
inside the checkout: only a configuration's first run builds them.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
from scipy.spatial import SphericalVoronoi

EARTH_RADIUS = 6371010.0
CACHE_DIR = Path(__file__).resolve().parent / ".cache" / "mesh"
# Bump when the arrays this module emits change.
FORMAT = 1


def fibonacci_sphere(n: int) -> np.ndarray:
    """n quasi-uniform unit vectors (golden-spiral lattice)."""
    i = np.arange(n, dtype=np.float64)
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    theta = 2.0 * np.pi * i / phi
    z = 1.0 - (2.0 * i + 1.0) / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=-1)


def build(n_cells: int, n_layers: int, seed: int = 0, jitter: float = 0.05,
          bottom_depth: float = 4000.0, radius: float = EARTH_RADIUS) -> dict:
    """The mesh's NetCDF-named arrays: x/y/zCell, x/y/zVertex, x/y/zEdge
    (m), nEdgesOnCell, verticesOnCell, cellsOnCell, edgesOnCell (nCells,
    maxEdges), cellsOnVertex (nVertices, 3), cellsOnEdge, verticesOnEdge
    (nEdges, 2), refBottomDepth (nVertLevels,)."""
    pts = fibonacci_sphere(n_cells)
    if jitter > 0.0:
        rng = np.random.default_rng(seed)
        spacing = 2.0 / np.sqrt(n_cells)
        pts = pts + rng.normal(scale=jitter * spacing, size=pts.shape)
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    sv = SphericalVoronoi(pts, radius=1.0, threshold=1e-10)
    sv.sort_vertices_of_regions()
    verts = sv.vertices
    nv = verts.shape[0]
    lens = np.fromiter(map(len, sv.regions), dtype=np.int64, count=n_cells)
    flat = np.fromiter((v for reg in sv.regions for v in reg), dtype=np.int64,
                       count=int(lens.sum()))
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cell_of = np.repeat(np.arange(n_cells), lens)
    k_of = np.arange(flat.size) - np.repeat(start, lens)

    # counter-clockwise from outside: cross(v0, v1) . p >= 0, else reverse
    a, b = verts[flat[start]], verts[flat[start + 1]]
    flip = np.einsum("nd,nd->n", np.cross(a, b), pts) < 0.0
    rev = np.where(np.repeat(flip, lens),
                   np.repeat(start + lens - 1, lens) - k_of, start[cell_of]
                   + k_of)
    flat = flat[rev]

    max_edges = int(lens.max())
    nxt = np.where(k_of == np.repeat(lens, lens) - 1, start[cell_of],
                   np.arange(flat.size) + 1)
    lo = np.minimum(flat, flat[nxt])
    hi = np.maximum(flat, flat[nxt])
    key = lo * nv + hi
    uniq, first, inverse = np.unique(key, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")      # first-appearance order
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    eid = rank[inverse]                           # edge id of each (cell, k)
    ne = uniq.size

    # the (at most two) cells of each edge, in cell order
    by_edge = np.lexsort((cell_of, eid))
    e_sorted, c_sorted = eid[by_edge], cell_of[by_edge]
    head = np.concatenate([[True], e_sorted[1:] != e_sorted[:-1]])
    cells_on_edge = np.zeros((ne, 2), dtype=np.int64)
    cells_on_edge[e_sorted[head], 0] = c_sorted[head] + 1
    cells_on_edge[e_sorted[~head], 1] = c_sorted[~head] + 1
    other = np.where(cells_on_edge[eid, 0] == cell_of + 1,
                     cells_on_edge[eid, 1], cells_on_edge[eid, 0])

    def padded(values):
        out = np.zeros((n_cells, max_edges), dtype=np.int64)
        out[cell_of, k_of] = values
        return out

    by_vertex = np.lexsort((cell_of, flat))
    v_sorted, cv_sorted = flat[by_vertex], cell_of[by_vertex]
    counts = np.bincount(v_sorted, minlength=nv)
    if not (counts == 3).all():
        raise ValueError("non-generic Voronoi vertex (touching != 3 cells); "
                         "use jitter > 0")
    cells_on_vertex = cv_sorted.reshape(nv, 3) + 1

    pair = np.stack([uniq // nv, uniq % nv], axis=1)[order]
    edge_xyz = verts[pair[:, 0]] + verts[pair[:, 1]]
    edge_xyz /= np.linalg.norm(edge_xyz, axis=-1, keepdims=True)
    cell_xyz, vertex_xyz, edge_xyz = (pts * radius, verts * radius,
                                      edge_xyz * radius)
    out = {"nEdgesOnCell": lens.astype(np.int32),
           "verticesOnCell": padded(flat + 1).astype(np.int32),
           "cellsOnCell": padded(other).astype(np.int32),
           "edgesOnCell": padded(eid + 1).astype(np.int32),
           "cellsOnVertex": cells_on_vertex.astype(np.int32),
           "cellsOnEdge": cells_on_edge.astype(np.int32),
           "verticesOnEdge": (pair + 1).astype(np.int32),
           "refBottomDepth": np.linspace(bottom_depth / n_layers,
                                         bottom_depth, n_layers)}
    for name, xyz in (("Cell", cell_xyz), ("Vertex", vertex_xyz),
                      ("Edge", edge_xyz)):
        for axis, c in zip("xyz", xyz.T):
            out[f"{axis}{name}"] = np.ascontiguousarray(c)
    return out


def mesh_args(config: dict) -> dict:
    """build()'s arguments from a configuration file."""
    m = config["mesh"]
    return {"n_cells": int(config["n_cells"]),
            "n_layers": int(config["n_vert_levels"]),
            "seed": int(m["seed"]), "jitter": float(m["jitter"]),
            "bottom_depth": float(m["bottom_depth"])}


def load(config: dict, cache_dir: Path = CACHE_DIR) -> tuple[dict, bool]:
    """(arrays, built): the configuration's mesh from the cache, built and
    stored there on a miss."""
    args = mesh_args(config)
    key = hashlib.sha1(json.dumps([FORMAT, args], sort_keys=True)
                       .encode()).hexdigest()[:16]
    path = Path(cache_dir) / f"{config['name']}-{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in z.files}, False
    arrays = build(**args)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".part")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return arrays, True
