"""Per-timestep solution fields and derived-field preprocessing (mirror of
mops_tpu.solution).

Follows the reference preprocessing pipeline (src/Core/MPASOSolution.cpp
:16-248): every per-(cell, layer) / per-(vertex, layer) kernel collapses into
one gather + weighted sum, and the per-cell RBF Gauss elimination becomes one
batched linear solve whose coefficients serve all vertical layers.
``preprocess`` runs on the card unless the caller asks for the CPU.

Layouts: scalar fields (n, L); vector fields (n, L, 3); all 0-based indices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import geo, interp
from .mesh import MPASMesh, resolve_device

# Vertex-axis chunk of cell_to_vertex: bounds the (chunk, 3, L[, 3]) gather
# transient independently of the mesh size.
_CTOV_CHUNK = 262144


def cell_center_ztop(layer_thickness: torch.Tensor,
                     bottom_depth: Optional[torch.Tensor] = None,
                     surface_height: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Z-coordinate of each layer's top at cell centers.

    Mirrors MPASOSolution::calcCellCenterZtop (reference
    src/Core/MPASOSolution.cpp:535-618):
      - with bottomDepth: accumulate thickness upward from z = -bottomDepth
        (bottomDepth wins if surfaceHeight also present);
      - with surfaceHeight: accumulate downward from z = ssh;
      - else: accumulate downward from z = 0.
    """
    lt = layer_thickness
    if bottom_depth is not None:
        # z_top[k] = -bottom + sum_{j >= k} thickness[j]  (reverse cumsum)
        rev = torch.flip(torch.cumsum(torch.flip(lt, [1]), dim=1), [1])
        return -bottom_depth[:, None] + rev
    if surface_height is not None:
        top = surface_height[:, None]
    else:
        top = torch.zeros((lt.shape[0], 1), dtype=lt.dtype, device=lt.device)
    # z_top[0] = top; z_top[k] = top - sum_{j < k} thickness[j]
    csum = torch.cumsum(lt, dim=1)
    return torch.cat([top, top - csum[:, :-1]], dim=1)


def _vertex_barycentric(mesh: MPASMesh):
    """Per-vertex (u, v, w) over the 3 cellsOnVertex + boundary mask, computed
    once and shared by all cell-to-vertex transfers of a solution."""
    cov = mesh.cells_on_vertex                       # (nV, 3)
    boundary = torch.any(cov < 0, dim=1)             # any missing cell -> 0.0
    safe = torch.clamp(cov, min=0).long()
    p0 = mesh.cell_xyz[safe[:, 0]]
    p1 = mesh.cell_xyz[safe[:, 1]]
    p2 = mesh.cell_xyz[safe[:, 2]]
    u, v, w = interp.triangle_barycentric(mesh.vertex_xyz, p0, p1, p2)
    weights = torch.stack([u, v, w], dim=-1)         # (nV, 3)
    weights = torch.where(boundary[:, None], torch.zeros_like(weights), weights)
    return safe, weights, boundary


def cell_to_vertex(mesh: MPASMesh, cell_field: torch.Tensor,
                   clamp_negative: bool = False) -> torch.Tensor:
    """Transfer a (nCells, L[, 3]) field to vertices by triangle barycentric.

    Mirrors SYCLBackend::CalcCellCenterToVertex and its ztop / velocity /
    vertical-velocity variants (reference src/GPU/SYCL/MPASOSolutionSYCL.cpp).
    Boundary vertices (a missing cell in cellsOnVertex) get exactly 0, like the
    reference's ``bBoundary`` branch.  ``clamp_negative`` reproduces the
    attribute variant's ``value < 0 -> 0`` clamp (MPASOSolutionSYCL.cpp:215).
    """
    safe, weights, boundary = _vertex_barycentric(mesh)
    nV = safe.shape[0]
    out = torch.empty((nV,) + tuple(cell_field.shape[1:]),
                      dtype=torch.result_type(cell_field, weights),
                      device=cell_field.device)
    for s in range(0, nV, _CTOV_CHUNK):
        e = min(s + _CTOV_CHUNK, nV)
        gathered = cell_field[safe[s:e]]             # (n, 3, L[,3])
        wshape = (e - s, 3) + (1,) * (gathered.ndim - 2)
        o = torch.sum(gathered * weights[s:e].reshape(wshape), dim=1)
        if clamp_negative:
            o = torch.where(o < 0, torch.zeros_like(o), o)
        bnd = boundary[s:e].reshape((-1,) + (1,) * (o.ndim - 1))
        out[s:e] = torch.where(bnd, torch.zeros_like(o), o)
    return out


def cell_center_velocity_zm(mesh: MPASMesh, zonal: torch.Tensor,
                            meridional: torch.Tensor) -> torch.Tensor:
    """(nCells, L) zonal/meridional -> (nCells, L, 3) XYZ velocity.

    Mirrors SYCLBackend::CalcCellCenterVelocityByZM (reference
    src/GPU/SYCL/MPASOSolutionSYCL.cpp:228-288).
    """
    pos = mesh.cell_xyz[:, None, :]                  # (nC, 1, 3)
    return geo.enu_velocity_to_xyz(pos, zonal, meridional, 0.0)


def vertex_velocity_zm(mesh: MPASMesh, vertex_zonal: torch.Tensor,
                       vertex_meridional: torch.Tensor) -> torch.Tensor:
    """Vertex-sited (nVertices, L) zonal/meridional -> (nVertices, L, 3)
    XYZ velocity (reference src/GPU/SYCL/MPASOSolutionSYCL.cpp:433-485)."""
    pos = mesh.vertex_xyz[:, None, :]
    return geo.enu_velocity_to_xyz(pos, vertex_zonal, vertex_meridional, 0.0)


def cell_center_velocity_rbf(mesh: MPASMesh,
                             normal_velocity: torch.Tensor) -> torch.Tensor:
    """Reconstruct (nCells, L, 3) cell-center velocity from edge-normal
    velocity (reference SYCLBackend::CalcCellCenterVelocity,
    src/GPU/SYCL/MPASOSolutionSYCL.cpp:290-431, alpha fixed to 1.0).

    The RBF coefficients depend only on mesh geometry, so they are computed
    once per cell and contracted against the (nEdges, L) normal-velocity
    table for all layers.  Lanes beyond a cell's real edge count contribute
    zero (the reference reads uninitialized stack memory there).
    """
    nc, me = mesh.edges_on_cell.shape
    lane = torch.arange(me, device=mesh.device)[None, :]
    valid = (lane < mesh.n_edges_on_cell[:, None]) & (mesh.edges_on_cell >= 0)
    eid = torch.clamp(mesh.edges_on_cell, min=0).long()   # (nC, K)

    edge_center = mesh.edge_xyz[eid]                 # (nC, K, 3)
    coe = mesh.cells_on_edge[eid]                    # (nC, K, 2)
    c0, c1 = coe[..., 0], coe[..., 1]
    both_valid = (c0 >= 0) & (c1 >= 0)
    # with one side missing, the reference's size_t min() picks the valid cell
    cmin = torch.where(both_valid, torch.minimum(c0, c1), torch.maximum(c0, c1))
    cmax = torch.maximum(c0, c1)
    pos_min = mesh.cell_xyz[torch.clamp(cmin, min=0).long()]
    pos_max = mesh.cell_xyz[torch.clamp(cmax, min=0).long()]
    normal = torch.where(both_valid[..., None], pos_max - pos_min,
                         edge_center - pos_min)
    nlen = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    degenerate = nlen[..., 0] == 0.0
    normal = normal / torch.where(nlen == 0.0, torch.ones_like(nlen), nlen)
    valid = valid & ~degenerate

    # Local ENU-ish tangent basis at the cell center (MPASOSolutionSYCL.cpp:352-361)
    up = mesh.cell_xyz / torch.linalg.vector_norm(mesh.cell_xyz, dim=-1,
                                                  keepdim=True)
    zhat = torch.tensor([0.0, 0.0, 1.0], dtype=up.dtype, device=up.device)
    yhat = torch.tensor([0.0, 1.0, 0.0], dtype=up.dtype, device=up.device)
    east = torch.linalg.cross(zhat.expand_as(up), up, dim=-1)
    elen = torch.linalg.vector_norm(east, dim=-1, keepdim=True)
    east_alt = torch.linalg.cross(yhat.expand_as(up), up, dim=-1)
    east = torch.where(elen < 1e-6, east_alt, east)
    east = east / torch.linalg.vector_norm(east, dim=-1, keepdim=True)
    north = torch.linalg.cross(up, east, dim=-1)
    basis = torch.stack([east, north], dim=1)        # (nC, 2, 3)

    coeffs = interp.rbf_plane_coefficients(
        edge_center, normal, mesh.cell_xyz, 1.0, basis, valid)   # (nC, K, 3)

    nvel = normal_velocity[eid]                      # (nC, K, L)
    nvel = torch.where(valid[..., None], nvel, torch.zeros_like(nvel))
    return torch.einsum("ckd,ckl->cld", coeffs, nvel)


@dataclasses.dataclass(frozen=True)
class SolutionFields:
    """Derived, advection-ready vertex fields for one timestep (reference
    MPASOSolution after preprocessing, src/Core/MPASOSolution.h:18-148)."""

    cell_ztop: torch.Tensor                    # (nC, L)
    vertex_ztop: torch.Tensor                  # (nV, L)
    cell_velocity: torch.Tensor                # (nC, L, 3)
    vertex_velocity: torch.Tensor              # (nV, L, 3)
    vertex_vert_velocity: torch.Tensor         # (nV, L+1)
    vertex_attrs: Dict[str, torch.Tensor]      # name -> (nV, L)
    cell_attrs: Dict[str, torch.Tensor]        # name -> (nC, L)
    timestamp: str = ""
    timestep: int = 0

    @property
    def n_layers(self) -> int:
        return self.cell_ztop.shape[1]

    def slim(self) -> "SolutionFields":
        """Drop the cell-sited tables to one-row stubs (mops_tpu's
        SolutionFields.slim).  Advection reads only the vertex fields, so a
        run that only advects need not hold the cell tables on the card
        (about 2.5 GB at 2M cells x L80 in float32); remap, regrid and
        attribute-recording runs need the full object."""
        return dataclasses.replace(
            self, cell_ztop=self.cell_ztop[:1],
            cell_velocity=self.cell_velocity[:1], cell_attrs={})

    def to(self, device=None, dtype: Optional[torch.dtype] = None
           ) -> "SolutionFields":
        """Move every table to ``device`` and cast it to ``dtype``."""
        cast = lambda a: a.to(device=device, dtype=dtype)
        return dataclasses.replace(
            self,
            cell_ztop=cast(self.cell_ztop),
            vertex_ztop=cast(self.vertex_ztop),
            cell_velocity=cast(self.cell_velocity),
            vertex_velocity=cast(self.vertex_velocity),
            vertex_vert_velocity=cast(self.vertex_vert_velocity),
            vertex_attrs={k: cast(v) for k, v in self.vertex_attrs.items()},
            cell_attrs={k: cast(v) for k, v in self.cell_attrs.items()},
        )


_RESERVED = {"layerThickness", "bottomDepth", "seaSurfaceHeight", "zTop",
             "velocityZonal", "velocityMeridional", "normalVelocity",
             "vertVelocityTop", "xtime", "zMid"}


def preprocess(mesh: MPASMesh, raw: Dict[str, object],
               timestamp: str = "", timestep: int = 0,
               dtype: Optional[torch.dtype] = None,
               device="cuda") -> SolutionFields:
    """Raw NetCDF-named arrays -> advection-ready SolutionFields, computed on
    ``device`` (the card unless the caller passes device="cpu"; without a
    card a CUDA request raises).  The mesh is moved there.

    Follows MOPSApp::addSol (reference src/Core/MOPSApp.cpp:77-137): ztop
    from layerThickness(+bottomDepth/ssh), cell-center velocity from
    zonal/meridional if present else RBF from normalVelocity, then every
    field transferred cell->vertex.  Any other (nCells, L) array in ``raw``
    becomes a named attribute (temperature, salinity, ...).  ``dtype`` casts
    the raw arrays; None keeps their own.
    """
    mesh = mesh.to(resolve_device(device))

    def tensor(v):
        return torch.as_tensor(v, device=mesh.device, dtype=dtype)

    def get(k):
        v = raw.get(k)
        return None if v is None else tensor(v)

    thickness = get("layerThickness")
    if thickness is None:
        raise ValueError("layerThickness is required")
    n_layers = thickness.shape[1]

    ztop = get("zTop")
    if ztop is None:
        ztop = cell_center_ztop(thickness, get("bottomDepth"),
                                get("seaSurfaceHeight"))
    vertex_ztop = cell_to_vertex(mesh, ztop)

    zonal, merid = get("velocityZonal"), get("velocityMeridional")
    if zonal is not None and merid is not None:
        cell_vel = cell_center_velocity_zm(mesh, zonal, merid)
    else:
        normal = get("normalVelocity")
        if normal is None:
            raise ValueError("need velocityZonal+velocityMeridional or normalVelocity")
        cell_vel = cell_center_velocity_rbf(mesh, normal)
    vertex_vel = cell_to_vertex(mesh, cell_vel)

    wvel = get("vertVelocityTop")
    if wvel is None:
        wvel = torch.zeros((mesh.n_cells, n_layers + 1), dtype=thickness.dtype,
                           device=mesh.device)
    vertex_wvel = cell_to_vertex(mesh, wvel)

    cell_attrs = {}
    vertex_attrs = {}
    for k, v in raw.items():
        if k in _RESERVED or v is None:
            continue
        v = tensor(v)
        if v.ndim == 2 and tuple(v.shape) == (mesh.n_cells, n_layers):
            cell_attrs[k] = v
            vertex_attrs[k] = cell_to_vertex(mesh, v, clamp_negative=True)

    return SolutionFields(
        cell_ztop=ztop,
        vertex_ztop=vertex_ztop,
        cell_velocity=cell_vel,
        vertex_velocity=vertex_vel,
        vertex_vert_velocity=vertex_wvel,
        vertex_attrs=vertex_attrs,
        cell_attrs=cell_attrs,
        timestamp=timestamp,
        timestep=timestep,
    )
