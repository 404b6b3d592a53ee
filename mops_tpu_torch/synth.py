"""Synthetic MPAS-like spherical Voronoi meshes + analytic solution fields.

Jax-free copy of mops_tpu.synth (same generators, same arithmetic, so the
meshes and fields are equal array for array): a spherical Voronoi
tessellation of quasi-uniform generator points is exactly the MPAS-O
cell/vertex/edge dual structure (Voronoi cells around generators, vertices =
Delaunay circumcenters shared by 3 cells).  The analytic solid-body fields
have closed-form trajectories.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import SphericalVoronoi

from .config import EARTH_RADIUS
from .mesh import MPASMesh


def fibonacci_sphere(n: int) -> np.ndarray:
    """n quasi-uniform unit vectors (golden-spiral lattice)."""
    i = np.arange(n, dtype=np.float64)
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    theta = 2.0 * np.pi * i / phi
    z = 1.0 - (2.0 * i + 1.0) / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=-1)


def build_voronoi_mesh(n_cells: int = 600,
                       radius: float = EARTH_RADIUS,
                       seed: int = 0,
                       jitter: float = 0.0,
                       land_box: tuple | None = None,
                       n_layers: int = 8,
                       bottom_depth: float = 4000.0,
                       name: str = "synth",
                       points: np.ndarray | None = None) -> MPASMesh:
    """Spherical Voronoi mesh with MPAS connectivity.

    Args:
      n_cells: number of Voronoi generators (= cells).
      radius: sphere radius in metres.
      jitter: optional random perturbation of generators (fraction of spacing).
      land_box: optional (min_lat, max_lat, min_lon, max_lon) degrees; cells
        whose center falls inside become "land": they are removed from the cell
        list, and connectivity entries referencing them become missing (-1),
        exercising the reference's boundary semantics.
    """
    if points is not None:
        pts = np.asarray(points, dtype=np.float64)
        pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
        n_cells = len(pts)
    else:
        pts = fibonacci_sphere(n_cells)
    if jitter > 0.0:
        rng = np.random.default_rng(seed)
        spacing = 2.0 / np.sqrt(n_cells)
        pts = pts + rng.normal(scale=jitter * spacing, size=pts.shape)
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)

    sv = SphericalVoronoi(pts, radius=1.0, threshold=1e-10)
    sv.sort_vertices_of_regions()
    verts = sv.vertices                       # (nV, 3) unit sphere
    regions = sv.regions                      # list of vertex-id lists (CCW-ish)

    nc = len(regions)
    nv = verts.shape[0]

    # Orient every region counter-clockwise as seen from outside the sphere so
    # that the containment test cross(A, B) . p >= 0 holds inside the cell
    # (reference SYCLKernel::IsInMesh, src/GPU/SYCL/Kernel/SYCLKernel.cpp:41-76).
    oriented = []
    for ci, reg in enumerate(regions):
        a = verts[reg[0]]
        b = verts[reg[1]]
        if np.dot(np.cross(a, b), pts[ci]) < 0.0:
            reg = reg[::-1]
        oriented.append(list(reg))
    regions = oriented

    max_edges = max(len(r) for r in regions)

    # Edge table: undirected vertex pair -> (edge_id, [cells])
    edge_of_pair: dict[tuple[int, int], int] = {}
    edge_cells: list[list[int]] = []
    edge_verts: list[tuple[int, int]] = []
    for ci, reg in enumerate(regions):
        n = len(reg)
        for k in range(n):
            pair = tuple(sorted((reg[k], reg[(k + 1) % n])))
            if pair not in edge_of_pair:
                edge_of_pair[pair] = len(edge_verts)
                edge_verts.append(pair)
                edge_cells.append([])
            edge_cells[edge_of_pair[pair]].append(ci)
    ne = len(edge_verts)

    vertices_on_cell = np.zeros((nc, max_edges), dtype=np.int64)   # 1-based, 0 = pad
    edges_on_cell = np.zeros((nc, max_edges), dtype=np.int64)
    cells_on_cell = np.zeros((nc, max_edges), dtype=np.int64)
    n_edges_on_cell = np.zeros(nc, dtype=np.int32)
    for ci, reg in enumerate(regions):
        n = len(reg)
        n_edges_on_cell[ci] = n
        for k in range(n):
            vertices_on_cell[ci, k] = reg[k] + 1
            pair = tuple(sorted((reg[k], reg[(k + 1) % n])))
            eid = edge_of_pair[pair]
            edges_on_cell[ci, k] = eid + 1
            cells = edge_cells[eid]
            other = [c for c in cells if c != ci]
            cells_on_cell[ci, k] = (other[0] + 1) if other else 0

    cells_on_vertex = np.zeros((nv, 3), dtype=np.int64)
    counts = np.zeros(nv, dtype=np.int32)
    for ci, reg in enumerate(regions):
        for v in reg:
            if counts[v] < 3:
                cells_on_vertex[v, counts[v]] = ci + 1
            counts[v] += 1
    if not (counts == 3).all():
        # Degenerate vertices (>3 cells) can appear with symmetric generators;
        # jitter the lattice to restore generic position.
        raise ValueError("non-generic Voronoi vertex (touching != 3 cells); "
                         "use jitter > 0")

    cells_on_edge = np.zeros((ne, 2), dtype=np.int64)
    vertices_on_edge = np.zeros((ne, 2), dtype=np.int64)
    for ei in range(ne):
        cs = edge_cells[ei]
        cells_on_edge[ei, 0] = cs[0] + 1
        cells_on_edge[ei, 1] = (cs[1] + 1) if len(cs) > 1 else 0
        vertices_on_edge[ei] = (edge_verts[ei][0] + 1, edge_verts[ei][1] + 1)

    edge_xyz_unit = verts[[p[0] for p in edge_verts]] + verts[[p[1] for p in edge_verts]]
    edge_xyz_unit /= np.linalg.norm(edge_xyz_unit, axis=-1, keepdims=True)

    if land_box is not None:
        min_lat, max_lat, min_lon, max_lon = np.deg2rad(np.asarray(land_box, dtype=np.float64))
        lat = np.arcsin(np.clip(pts[:, 2], -1, 1))
        lon = np.arctan2(pts[:, 1], pts[:, 0])
        land = (lat >= min_lat) & (lat <= max_lat) & (lon >= min_lon) & (lon <= max_lon)
        keep = ~land
        new_id = np.full(nc, 0, dtype=np.int64)          # 0 = missing (1-based)
        new_id[keep] = np.arange(int(keep.sum())) + 1

        def remap_cells(arr):
            out = np.where(arr > 0, new_id[np.clip(arr - 1, 0, nc - 1)], 0)
            return out

        cells_on_cell = remap_cells(cells_on_cell)[keep]
        cells_on_vertex = remap_cells(cells_on_vertex)
        cells_on_edge = remap_cells(cells_on_edge)
        vertices_on_cell = vertices_on_cell[keep]
        edges_on_cell = edges_on_cell[keep]
        n_edges_on_cell = n_edges_on_cell[keep]
        pts = pts[keep]

    # refBottomDepth: bottom of each layer for uniform thickness (matches the
    # solid_body_fields vertical grid; used by the fixed-latitude regrid).
    ref_bottom_depth = np.linspace(bottom_depth / n_layers, bottom_depth,
                                   n_layers)

    return MPASMesh.from_raw(
        cell_xyz=pts * radius,
        vertex_xyz=verts * radius,
        edge_xyz=edge_xyz_unit * radius,
        n_edges_on_cell=n_edges_on_cell,
        vertices_on_cell_1based=vertices_on_cell,
        cells_on_cell_1based=cells_on_cell,
        cells_on_vertex_1based=cells_on_vertex,
        edges_on_cell_1based=edges_on_cell,
        cells_on_edge_1based=cells_on_edge,
        vertices_on_edge_1based=vertices_on_edge,
        ref_bottom_depth=ref_bottom_depth,
        name=name,
    )


def build_gradient_mesh(n_cells: int = 4000,
                        ratio: float = 3.0,
                        radius: float = EARTH_RADIUS,
                        seed: int = 0,
                        jitter: float = 0.05,
                        n_layers: int = 8,
                        bottom_depth: float = 4000.0,
                        name: str = "synth-grad") -> MPASMesh:
    """Variable-resolution mesh like E3SM's oRRS18to6 (reference
    mpas.yaml:4-7): generator density varies smoothly by ~ratio^2 between a
    refined equatorial band and the coarse rest, giving mixed cell sizes and
    a wider nEdgesOnCell distribution (pentagons through octagons+) than the
    quasi-uniform Fibonacci lattice.

    Thinning a 2x-oversampled golden-spiral lattice by a smooth latitude
    density keeps generic position (no symmetric degeneracies) while the
    target cell count is hit to within sampling noise."""
    rng = np.random.default_rng(seed)
    over = int(np.ceil(n_cells * ratio ** 2 / (1 + (ratio ** 2 - 1) * 0.4)))
    cand = fibonacci_sphere(over)
    lat = np.arcsin(np.clip(cand[:, 2], -1, 1))
    # density in [1/ratio^2, 1]: refined where |lat| < ~25 deg, smooth tanh
    # shoulder (mixing-scale transition like 18to6's 18 km -> 6 km)
    w = 1.0 / ratio ** 2 + (1.0 - 1.0 / ratio ** 2) * 0.5 * (
        1.0 + np.tanh((0.45 - np.abs(lat)) / 0.2))
    keep = rng.uniform(size=over) < w * (n_cells / w.sum())
    pts = cand[keep]
    return build_voronoi_mesh(radius=radius, seed=seed, jitter=jitter,
                              n_layers=n_layers, bottom_depth=bottom_depth,
                              name=name, points=pts)


def solid_body_fields(mesh: MPASMesh,
                      n_layers: int = 8,
                      bottom_depth: float = 4000.0,
                      omega: float = 1e-5,
                      omega_decay: float = 0.5,
                      w_scale: float = 0.0,
                      bathymetry_amp: float = 0.0,
                      shelf_lon: float = None):
    """Analytic solution fields: solid-body rotation about the z-axis.

    Zonal velocity u = omega_k * r * cos(lat), meridional = 0, where
    omega_k = omega * omega_decay**k decays with layer.  A particle advected in
    layer k circles the globe at angular rate omega_k -- closed-form truth.

    ``bathymetry_amp`` > 0 modulates the column depth smoothly over the
    sphere (bottom = bottom_depth * (1 - amp*(0.5 + 0.5 sin(3 lon) cos(2 lat)));
    layers stay uniform WITHIN a column).  A particle advected across the
    resulting bathymetry gradients changes layer index rapidly -- the regime
    that exercises the layer-window miss fallback, which flat-bottom fields
    never do (real MPAS-O meshes are eddy-resolving with O(1)-fractional
    depth changes between neighboring columns).  With ``w_scale`` at a
    realistic vertVelocityTop magnitude (1e-4..1e-3 m/s) particles also
    drift vertically through their window.

    Returns a dict of raw solution arrays in the reference's NetCDF naming.
    """
    nc = mesh.n_cells
    cell = mesh.cell_xyz.detach().cpu().numpy()
    r = np.linalg.norm(cell, axis=-1)
    lat = np.arcsin(cell[:, 2] / r)
    lon = np.arctan2(cell[:, 1], cell[:, 0])

    bottom = np.full(nc, bottom_depth)
    if bathymetry_amp:
        shape = 0.5 + 0.5 * np.sin(3.0 * lon) * np.cos(2.0 * lat)
        bottom = bottom_depth * (1.0 - bathymetry_amp * shape)
    if shelf_lon is not None:
        # continental-shelf step: the column collapses to 10% depth inside
        # two MERIDIONAL bands (sin(2 lon) > shelf_lon).  The solid-body
        # flow is zonal, so every particle sweeps across the shelf edges; a
        # cell-to-cell depth discontinuity is what makes the layer index
        # JUMP many layers in one step -- the regime that can outrun the
        # advection window's guard band (smooth bathymetry is absorbed by
        # the per-step layer-hint carry).
        bottom = np.where(np.sin(2.0 * lon) > shelf_lon, 0.1 * bottom,
                          bottom)
    thickness = np.repeat((bottom / n_layers)[:, None], n_layers, axis=1)

    k = np.arange(n_layers)
    omega_k = omega * omega_decay ** k                      # (L,)
    u_zonal = omega_k[None, :] * (r * np.cos(lat))[:, None]  # (nC, L)
    v_merid = np.zeros_like(u_zonal)
    w = np.full((nc, n_layers + 1), w_scale)
    if bathymetry_amp and w_scale:
        # spatially alternating vertical velocity: some particles rise, some
        # sink, so vertical window drift happens in both directions
        w = w * np.sin(2.0 * lon + lat)[:, None]

    temperature = 20.0 - 15.0 * (k / max(1, n_layers - 1))[None, :] \
        + 5.0 * np.cos(lat)[:, None]
    salinity = 34.0 + np.sin(lat)[:, None] * np.ones((1, n_layers))

    return {
        "bottomDepth": bottom,
        "layerThickness": thickness,
        "velocityZonal": u_zonal,
        "velocityMeridional": v_merid,
        "vertVelocityTop": w,
        "temperature": temperature,
        "salinity": salinity,
    }


def solid_body_normal_velocity(mesh: MPASMesh,
                               n_layers: int = 8,
                               omega: float = 1e-5,
                               omega_decay: float = 0.5) -> np.ndarray:
    """Edge-normal velocity (nEdges, L) of the solid-body field, for the RBF
    reconstruction path (reference CalcCellCenterVelocity), as numpy
    (mops_tpu.synth.solid_body_normal_velocity).

    The per-edge normal direction follows the reference's convention: the
    unit vector from the lower-id adjacent cell center to the higher-id one,
    or from the lower-id cell to the edge midpoint on the boundary
    (reference src/CPU/TBB/MPASOSolutionTBB.cpp:192-216).  n_e = v(edge).n.
    """
    edge = mesh.edge_xyz.detach().cpu().numpy()
    r = np.linalg.norm(edge, axis=-1)
    lat = np.arcsin(np.clip(edge[:, 2] / r, -1.0, 1.0))
    lon = np.arctan2(edge[:, 1], edge[:, 0])
    k = np.arange(n_layers)
    omega_k = omega * omega_decay ** k
    speed = omega_k[None, :] * (r * np.cos(lat))[:, None]     # (nE, L)
    east = np.stack([-np.sin(lon), np.cos(lon), np.zeros_like(lon)], axis=-1)
    v_xyz = speed[..., None] * east[:, None, :]               # (nE, L, 3)

    coe = mesh.cells_on_edge.detach().cpu().numpy()
    c0, c1 = coe[:, 0], coe[:, 1]
    both = (c0 >= 0) & (c1 >= 0)
    cmin = np.where(both, np.minimum(c0, c1), np.maximum(c0, c1))
    cmax = np.maximum(c0, c1)
    cell = mesh.cell_xyz.detach().cpu().numpy()
    normal = np.where(both[:, None], cell[np.clip(cmax, 0, None)]
                      - cell[np.clip(cmin, 0, None)],
                      edge - cell[np.clip(cmin, 0, None)])
    nlen = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / np.where(nlen == 0, 1.0, nlen)
    return np.einsum("eld,ed->el", v_xyz, normal)
