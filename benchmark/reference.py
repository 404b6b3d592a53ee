"""The plain reference the benchmark holds the program to: MPAS-Ocean
particle tracing and fixed-depth remap, in torch ops on any device, float64
unless told otherwise.

It works everything out again from the raw arrays the benchmark hands to
the program (the mesh's NetCDF arrays, the raw cell fields): the vertex
tables (cell-to-vertex barycentric transfer, the column tops, the cell
velocity from its zonal and meridional parts), the seed cells (exact
nearest cell centre), the relocation each step (the nearest of the cell and
its neighbours), the RK4 or Euler step (containment, Wachspress weights,
the monotone column clamp, the binary (streamline) or first-hit (pathline)
layer search, the vertical lerp, the pathline's blend of two snapshots and
its two recorded attributes), the depth and radius update, the record
cadence and the trajectories' NaN cleanup; and, for an image, the pixel
positions, their cells, the depth search and the NaN masks.  The semantics
are those of the reference's CPU backend (MPASOVisualizerKernels.cpp) as
the port's plain steps state them; the code is the benchmark's own and
imports nothing of the program.  One departure: the column clamp z'[k] =
min(z[k], z'[k-1] - 1e-9) is taken in its cumulative-minimum form, which
differs from the sequential recurrence by less than 1e-9 m.

``Arith`` sets the precision: float64 is the reference; float32 with
``tf32`` is the control (every weighted sum, the contractions a matrix
unit would take, rounds both operands to TF32 first).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from scipy.spatial import cKDTree

EARTH_RADIUS = 6371010.0
EPS_LAYER = 1e-8
EPS_ZERO = 1e-12
ZTOP_CLAMP = 1e-9
# Raw arrays that are not attributes (reference MOPSApp::addSol).
RESERVED = {"layerThickness", "bottomDepth", "seaSurfaceHeight", "zTop",
            "velocityZonal", "velocityMeridional", "normalVelocity",
            "vertVelocityTop", "xtime", "zMid"}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero, as the tensor cores convert them."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


@dataclasses.dataclass(frozen=True)
class Arith:
    """The precision of a reference run."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def wsum(self, eq: str, w: torch.Tensor, x: torch.Tensor):
        """A weighted sum (einsum ``eq`` of weights and values)."""
        if self.tf32:
            w, x = tf32(w), tf32(x)
        return torch.einsum(eq, w, x)


F64 = Arith()
CONTROL = Arith(torch.float32, tf32=True)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# mesh and preprocessing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """0-based tables (-1: missing) on one device; ``tree`` is a KD-tree of
    the cell centres on the host."""

    cell_xyz: torch.Tensor
    vertex_xyz: torch.Tensor
    n_edges_on_cell: torch.Tensor
    vertices_on_cell: torch.Tensor
    cells_on_cell: torch.Tensor
    cells_on_vertex: torch.Tensor
    tree: cKDTree

    @property
    def n_cells(self) -> int:
        return self.cell_xyz.shape[0]


def _zero_based(raw, n_targets: int, device) -> torch.Tensor:
    a = np.asarray(raw, dtype=np.int64) - 1
    a[(a < 0) | (a >= n_targets)] = -1
    return torch.as_tensor(a, device=device)


def mesh_from_arrays(arrays: dict, device, dtype=torch.float64) -> Mesh:
    """A Mesh from a mesh file's arrays (meshgen's names)."""
    def xyz(name):
        return np.stack([arrays[f"{a}{name}"] for a in "xyz"], axis=-1)
    cells = xyz("Cell").astype(np.float64)
    nc, nv = cells.shape[0], arrays["cellsOnVertex"].shape[0]
    return Mesh(
        cell_xyz=torch.as_tensor(cells, device=device, dtype=dtype),
        vertex_xyz=torch.as_tensor(xyz("Vertex"), device=device, dtype=dtype),
        n_edges_on_cell=torch.as_tensor(
            np.asarray(arrays["nEdgesOnCell"], np.int64), device=device),
        vertices_on_cell=_zero_based(arrays["verticesOnCell"], nv, device),
        cells_on_cell=_zero_based(arrays["cellsOnCell"], nc, device),
        cells_on_vertex=_zero_based(arrays["cellsOnVertex"], nc, device),
        tree=cKDTree(cells))


def nearest_cells(mesh: Mesh, points: np.ndarray) -> np.ndarray:
    """The nearest cell centre of each (N, 3) point (exact L2)."""
    _, idx = mesh.tree.query(np.asarray(points, np.float64), k=1, workers=-1)
    return idx.astype(np.int64)


@dataclasses.dataclass
class Snapshot:
    """A snapshot's vertex tables: ztop (nV, L), velocity (nV, L, 3),
    vertical velocity (nV, L + 1), attributes (nV, L, A) in name order
    (None without any)."""

    ztop: torch.Tensor
    vel: torch.Tensor
    wvel: torch.Tensor
    attrs: Optional[torch.Tensor]
    attr_names: tuple


def _enu_coeffs(p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rxy = torch.sqrt(x * x + y * y)
    rxyz = torch.sqrt(x * x + y * y + z * z)
    at_pole = (x == 0.0) & (y == 0.0)
    safe_rxy = torch.where(at_pole, torch.ones_like(rxy), rxy)
    safe_rxyz = torch.where(rxyz == 0.0, torch.ones_like(rxyz), rxyz)
    return y / safe_rxy, x / safe_rxy, z / safe_rxyz, rxy / safe_rxyz, at_pole


def enu_to_xyz(p, uzon, umer):
    """(zonal, meridional) velocity at p -> XYZ (no vertical part)."""
    slon, clon, slat, clat, at_pole = _enu_coeffs(p)
    vx = -slon * uzon - slat * clon * umer
    vy = clon * uzon - slat * slon * umer
    vz = clat * umer
    zero = torch.zeros_like(vx)
    return torch.stack([torch.where(at_pole, zero, vx),
                        torch.where(at_pole, zero, vy),
                        torch.where(at_pole, zero, vz)], dim=-1)


def xyz_to_enu(p, vel):
    """XYZ velocity at p -> (zonal, meridional)."""
    slon, clon, slat, clat, at_pole = _enu_coeffs(p)
    vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
    uzon = -slon * vx + clon * vy
    umer = -slat * (clon * vx + slon * vy) + clat * vz
    zero = torch.zeros_like(uzon)
    return torch.where(at_pole, zero, uzon), torch.where(at_pole, zero, umer)


def preprocess(mesh: Mesh, raw: dict, ar: Arith = F64) -> Snapshot:
    """Raw cell fields -> vertex tables (reference MOPSApp::addSol): ztop
    from the thicknesses up from -bottomDepth, cell velocity from the zonal
    and meridional parts, each field moved to the vertices by the
    barycentric weights of its three cells (0 at a vertex with a missing
    cell), attributes clamped at 0 from below."""
    dev, dt = mesh.cell_xyz.device, ar.dtype

    def get(name):
        return torch.as_tensor(raw[name], device=dev).to(dt)

    thickness = get("layerThickness")
    ztop = -get("bottomDepth")[:, None] + torch.flip(
        torch.cumsum(torch.flip(thickness, [1]), dim=1), [1])
    cov = mesh.cells_on_vertex
    boundary = (cov < 0).any(dim=1)
    safe = cov.clamp(min=0)
    cx = mesh.cell_xyz.to(dt)
    a, b, c = cx[safe[:, 0]], cx[safe[:, 1]], cx[safe[:, 2]]
    p = mesh.vertex_xyz.to(dt)
    v0, v1, v2 = b - a, c - a, p - a
    d00, d01 = (v0 * v0).sum(-1), (v0 * v1).sum(-1)
    d11, d20, d21 = (v1 * v1).sum(-1), (v2 * v0).sum(-1), (v2 * v1).sum(-1)
    denom = d00 * d11 - d01 * d01
    bv = (d11 * d20 - d01 * d21) / denom
    bw = (d00 * d21 - d01 * d20) / denom
    weights = torch.stack([1.0 - bv - bw, bv, bw], dim=-1)
    weights = _where0(~boundary[:, None], weights)

    def to_vertex(field, clamp_negative=False):
        out = []
        for s in range(0, safe.shape[0], 1 << 18):
            g = field[safe[s:s + (1 << 18)]]              # (n, 3, L[, 3])
            eq = "nj,njl->nl" if g.ndim == 3 else "nj,njlc->nlc"
            o = ar.wsum(eq, weights[s:s + (1 << 18)], g)
            if clamp_negative:
                o = torch.where(o < 0, torch.zeros_like(o), o)
            bnd = boundary[s:s + (1 << 18)].reshape((-1,) + (1,) *
                                                    (o.ndim - 1))
            out.append(_where0(~bnd, o))
        return torch.cat(out)

    cell_vel = enu_to_xyz(cx[:, None, :], get("velocityZonal"),
                          get("velocityMeridional"))
    names = tuple(sorted(k for k, v in raw.items() if k not in RESERVED
                         and v is not None and tuple(v.shape)
                         == tuple(thickness.shape)))
    attrs = torch.stack([to_vertex(get(k), True) for k in names], dim=-1) \
        if names else None
    return Snapshot(ztop=to_vertex(ztop), vel=to_vertex(cell_vel),
                    wvel=to_vertex(get("vertVelocityTop")), attrs=attrs,
                    attr_names=names)


# ---------------------------------------------------------------------------
# geometry of a stage
# ---------------------------------------------------------------------------

def cell_vertices(mesh: Mesh, cell: torch.Tensor):
    """(vids clipped to >= 0, nv, vids_ok) of each cell."""
    raw = mesh.vertices_on_cell[cell]
    nv = mesh.n_edges_on_cell[cell]
    lane = torch.arange(raw.shape[1], device=cell.device)[None, :]
    ok = torch.all((lane >= nv[:, None]) | (raw >= 0), dim=1)
    return raw.clamp(min=0), nv, ok


def in_mesh(pos, vpos, nv, lane_valid):
    """Inside the spherical polygon: cross(A - p, B - p) . p >= 0 on every
    edge, and p finite."""
    K = vpos.shape[1]
    lane = torch.arange(K, device=pos.device)[None, :]
    nxt = torch.where(lane == nv[:, None] - 1, 0, (lane + 1) % K)
    b = vpos.gather(1, nxt[..., None].expand(vpos.shape))
    p = pos[:, None, :]
    d = (torch.linalg.cross(vpos - p, b - p, dim=-1) * p).sum(-1)
    inside = torch.all(~lane_valid | (d >= 0.0), dim=1)
    return inside & torch.isfinite(pos).all(-1)


def _area(a, b, c):
    a, b, c = torch.broadcast_tensors(a, b, c)
    return 0.5 * _norm(torch.linalg.cross(b - a, c - a, dim=-1))


def wachspress(p, poly, nv):
    """Wachspress weights of p in the polygon poly (N, K, 3) of nv
    vertices; padded lanes 0."""
    K = poly.shape[-2]
    lane = torch.arange(K, device=poly.device)
    n = nv[:, None]
    nxt = torch.where(lane == n - 1, 0, (lane + 1) % K)
    prv = torch.where(lane == 0, n - 1, lane - 1)

    def take(idx):
        return poly.gather(1, idx.expand(poly.shape[:-1])[..., None]
                           .expand(poly.shape))
    v_next, v_prev = take(nxt), take(prv)
    pb = p[:, None, :]
    w = _area(v_prev, poly, v_next) / (_area(v_prev, poly, pb)
                                       * _area(poly, v_next, pb))
    w = torch.where(lane < n, w, torch.zeros_like(w))
    return w * (1.0 / w.sum(-1, keepdim=True))


def clamp_profile(z):
    """The monotone column clamp, cumulative-minimum form."""
    idx = torch.arange(z.shape[-1], dtype=z.dtype, device=z.device) \
        * ZTOP_CLAMP
    return torch.cummin(z + idx, dim=-1).values - idx


def layer_binary(z, depth):
    """Streamline layer (reference kernel :903-944): above the surface 1,
    below the bottom L-1, else the binary search with ceil(log2 L) + 2
    probes; not found 1."""
    L = z.shape[1]
    above = depth > z[:, 0] + EPS_LAYER
    below = depth < z[:, -1] - EPS_LAYER
    lo = torch.ones(depth.shape, dtype=torch.long, device=z.device)
    hi = torch.full_like(lo, L - 1)
    ans = torch.ones_like(lo)
    found = torch.zeros(depth.shape, dtype=torch.bool, device=z.device)
    for _ in range(int(np.ceil(np.log2(max(2, L)))) + 2):
        active = ~found & (lo <= hi)
        mid = (lo + hi) >> 1
        top = z.gather(1, (mid - 1).clamp(0, L - 1)[:, None])[:, 0]
        bot = z.gather(1, mid.clamp(0, L - 1)[:, None])[:, 0]
        hit = (depth <= top + EPS_LAYER) & (depth >= bot - EPS_LAYER)
        ans = torch.where(active & hit, mid, ans)
        found = found | (active & hit)
        up = depth > top + EPS_LAYER
        hi = torch.where(active & ~hit & up, mid - 1, hi)
        lo = torch.where(active & ~hit & ~up, mid + 1, lo)
    ans = ans.clamp(1, L - 1)
    return torch.where(above, 1, torch.where(below, L - 1, ans))


def layer_linear(z, depth):
    """Pathline layer (reference kernel :1182-1222) of (..., N, L)
    profiles: above 1, below L-1, else the first interval holding the
    depth; (layer, ok)."""
    L = z.shape[-1]
    above = depth > z[..., 0] + EPS_LAYER
    below = depth < z[..., -1] - EPS_LAYER
    cond = (depth[..., None] <= z[..., :-1] + EPS_LAYER) \
        & (depth[..., None] >= z[..., 1:] - EPS_LAYER)
    first = torch.argmax(cond.to(torch.uint8), dim=-1) + 1
    layer = torch.where(above, 1, torch.where(below, L - 1, first))
    return layer, above | below | cond.any(-1)


def lerp_t(z, layer, depth):
    """(t, ok) of the vertical lerp between layer-1 and layer."""
    z_dn = z.gather(-1, layer[..., None])[..., 0]
    z_up = z.gather(-1, (layer - 1)[..., None])[..., 0]
    x = torch.minimum(torch.maximum(depth, z_dn), z_up)
    denom = z_up - z_dn
    ok = denom.abs() >= EPS_ZERO
    return (x - z_dn) / torch.where(ok, denom, torch.ones_like(denom)), ok


def _pick(cols, w, layer, ar):
    """sum_k w_k cols[s, n, k, layer[s, n], c] of (S, N, K, L, C) columns."""
    S, N, K, _, C = cols.shape
    idx = layer[:, :, None, None, None].expand(S, N, K, 1, C)
    return ar.wsum("nk,snkc->snc", w, cols.gather(3, idx)[:, :, :, 0])


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _stage(cols, p, depth_neg, alpha, nv, lane_valid, vpos, pathline, ar):
    """One velocity evaluation: (hvel, wvel, attr (N, 3), ok), zeros where
    it fails.  ``cols`` = (ztop, vel, wvel, attrs) gathered columns with a
    leading snapshot axis; a pathline blends alpha * back + (1 - alpha) *
    front."""
    ztop, vel, wvel, attrs = cols
    inside = in_mesh(p, vpos, nv, lane_valid)
    w = wachspress(p, vpos, nv)
    z = clamp_profile(ar.wsum("nk,snkl->snl", w, ztop))
    if pathline:
        layer, ok_layer = layer_linear(z, depth_neg)
    else:
        layer = layer_binary(z[0], depth_neg)[None]
        ok_layer = torch.ones_like(layer, dtype=torch.bool)
    t, ok_denom = lerp_t(z, layer, depth_neg)
    v_up, v_dn = _pick(vel, w, layer - 1, ar), _pick(vel, w, layer, ar)
    hvel = t[..., None] * v_up + (1.0 - t[..., None]) * v_dn
    lp1 = wvel.shape[3]
    wc = wvel[..., None]
    w_up = _pick(wc, w, (layer - 1).clamp(min=0).clamp(max=lp1 - 1), ar)[..., 0]
    w_dn = _pick(wc, w, layer.clamp(max=lp1 - 1), ar)[..., 0]
    wv = t * w_up + (1.0 - t) * w_dn
    attr = torch.zeros_like(p)
    if not pathline:
        ok = inside & ok_denom[0] & (_norm(v_dn[0]) >= EPS_ZERO) \
            & (_norm(v_up[0]) >= EPS_ZERO) & (_norm(hvel[0]) >= EPS_ZERO)
        return (_where0(ok[:, None], hvel[0]), _where0(ok, wv[0]), attr, ok)
    a = alpha
    hv = a * hvel[1] + (1.0 - a) * hvel[0]
    wv = a * wv[1] + (1.0 - a) * wv[0]
    if attrs is not None:
        at = t[..., None] * _pick(attrs, w, layer - 1, ar) \
            + (1.0 - t[..., None]) * _pick(attrs, w, layer, ar)
        n_at = at.shape[-1]
        attr[:, :n_at] = a * at[1] + (1.0 - a) * at[0]
    ok = inside & (ok_layer & ok_denom).all(0)
    return (_where0(ok[:, None], hv), _where0(ok, wv),
            _where0(ok[:, None], attr), ok)


def rotate(point, axis, theta):
    """Rodrigues rotation of point about axis (normalised, no zero guard)."""
    ct, st = torch.cos(theta), torch.sin(theta)
    u = axis / _norm(axis)[..., None]
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    px, py, pz = point[..., 0], point[..., 1], point[..., 2]
    omc = 1.0 - ct
    return torch.stack([
        (ct + ux * ux * omc) * px + (ux * uy * omc - uz * st) * py
        + (ux * uz * omc + uy * st) * pz,
        (uy * ux * omc + uz * st) * px + (ct + uy * uy * omc) * py
        + (uy * uz * omc - ux * st) * pz,
        (uz * ux * omc - uy * st) * px + (uz * uy * omc + ux * st) * py
        + (ct + uz * uz * omc) * pz], dim=-1)


def _on_sphere(pos, vel, dt):
    """RK mid-stage move: rotate pos by |v| dt / |p| about pos x vel
    (identity where |p| or |v| < 1e-12)."""
    rr, speed = _norm(pos), _norm(vel)
    bad = (rr < EPS_ZERO) | (speed < EPS_ZERO)
    axis = torch.linalg.cross(pos, vel, dim=-1)
    theta = speed * dt / torch.where(rr == 0.0, torch.ones_like(rr), rr)
    unit_x = torch.zeros_like(pos)
    unit_x[:, 0] = 1.0
    out = rotate(pos, torch.where(bad[:, None], unit_x, axis), theta)
    return torch.where(bad[:, None], pos, out)


def step(cols, pos, depth_neg, nv, vpos, dt, alphas, euler, pathline, ar):
    """One RK4 (or Euler) step in a frozen cell: (new_pos, hvel, wvel,
    attr, ok)."""
    lane_valid = torch.arange(vpos.shape[1], device=pos.device)[None, :] \
        < nv[:, None]
    a1, a2, a4 = alphas

    def at(p, a):
        return _stage(cols, p, depth_neg, a, nv, lane_valid, vpos, pathline,
                      ar)
    r = _norm(pos)
    if euler:
        hvel, wvel, attr, ok = at(pos, a1)
        theta = _norm(hvel) * dt / r.clamp(min=EPS_ZERO)
        return (rotate(pos, torch.linalg.cross(pos, hvel, dim=-1), theta),
                hvel, wvel, attr, ok)
    k1, w1, t1, ok1 = at(pos, a1)
    k2, w2, t2, ok2 = at(_on_sphere(pos, k1, dt * 0.5), a2)
    k3, w3, t3, ok3 = at(_on_sphere(pos, k2, dt * 0.5), a2)
    k4, w4, t4, ok4 = at(_on_sphere(pos, k3, dt), a4)
    hvel = (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    wvel = (w1 + 2.0 * w2 + 2.0 * w3 + w4) / 6.0
    attr = (t1 + 2.0 * t2 + 2.0 * t3 + t4) / 6.0
    trial = pos + hvel * dt
    tl = _norm(trial)
    new = torch.where((tl > EPS_ZERO)[:, None],
                      trial / torch.where(tl == 0.0, torch.ones_like(tl),
                                          tl)[:, None] * r[:, None], pos)
    return new, hvel, wvel, attr, ok1 & ok2 & ok3 & ok4


def relocate(mesh: Mesh, pos, cell):
    """The nearest of the cell's centre and its neighbours' (first minimum
    over neighbours in order, then the cell itself)."""
    coc = mesh.cells_on_cell[cell]
    nv = mesh.n_edges_on_cell[cell]
    K = coc.shape[1]
    valid = (coc >= 0) & (coc < mesh.n_cells)
    nb = mesh.cell_xyz[coc.clamp(0, mesh.n_cells - 1)]
    nb = torch.where(valid[..., None], nb, torch.full_like(nb, float("inf")))
    row = torch.cat([nb, mesh.cell_xyz[cell][:, None, :]], dim=1)
    lane = torch.arange(K + 1, device=pos.device)[None, :]
    d2 = ((row - pos[:, None, :]) ** 2).sum(-1)
    d2 = torch.where(lane == nv[:, None], d2[:, K:],
                     torch.where(lane >= nv[:, None], float("inf"), d2))
    best = torch.argmin(d2, dim=1)
    pick = coc.gather(1, best.clamp(max=K - 1)[:, None])[:, 0]
    return torch.where(best == nv, cell, pick)


def schedule(traj: dict, pathline: bool):
    """(n_steps, n_records, record flags, record slots, signed dt)."""
    dt, duration, rec = (int(traj["delta_t"]), int(traj["duration"]),
                         int(traj["record_t"]))
    n_steps, n_rec = duration // dt, duration // rec
    i = np.arange(n_steps)
    if pathline:
        interval = rec // dt
        flags = np.zeros(n_steps, bool) if interval <= 0 \
            else (i + 1) % interval == 0
    else:
        flags = ((i + 1) * abs(dt)) % rec == 0
    slots = np.where(flags, np.cumsum(flags) - 1, 0)
    sign = -1 if traj.get("direction", "forward") == "backward" else 1
    return n_steps, n_rec, flags & (slots < n_rec), slots, float(sign * dt)


@dataclasses.dataclass
class _State:
    """Particles on the device, updated in place by each step (so that a
    captured step replays on the same buffers)."""

    pos: torch.Tensor
    depth: torch.Tensor
    cell: torch.Tensor
    alive: torch.Tensor


def _advance(mesh: Mesh, tables, vxyz, st: _State, alphas, dt: float,
             euler: bool, freeze: bool, pathline: bool, relocate_first: bool,
             ar: Arith):
    """One step of every particle of ``st``, in place: relocate (unless the
    first step), the step in the frozen cell, the depth and radius update.
    Returns (hvel, attr, write) for the records."""
    real = st.pos.dtype
    pos, depth, alive = st.pos, st.depth, st.alive
    depth_neg = (-depth).to(real)
    cell = st.cell
    if relocate_first:
        cell = torch.where(alive, relocate(mesh, pos, cell), cell)
    vids, nv, vids_ok = cell_vertices(mesh, cell)
    cols = tuple(None if tab is None else torch.stack([t[vids] for t in tab])
                 for tab in tables)
    new_pos, hv, wv, at, ok = step(cols, pos, depth_neg, nv, vxyz[vids], dt,
                                   alphas, euler, pathline, ar)
    hv = _where0(vids_ok[:, None], hv)
    wv = _where0(vids_ok, wv)
    new_pos = torch.where(vids_ok[:, None], new_pos, pos)
    write = alive & ok & vids_ok if freeze else alive
    r = _norm(pos)
    new_depth = (depth.to(real) - wv * dt).clamp(min=0.0)
    r_new = (r + wv * dt).clamp(min=1.0)
    nl = _norm(new_pos)
    new_pos = torch.where(
        (nl > EPS_ZERO)[:, None],
        new_pos / torch.where(nl == 0.0, torch.ones_like(nl),
                              nl)[:, None] * r_new[:, None], new_pos)
    st.pos.copy_(torch.where(write[:, None], new_pos, pos))
    st.depth.copy_(torch.where(write, new_depth.to(torch.float32), depth))
    st.cell.copy_(cell)
    st.alive.copy_(write)
    return hv, _where0(vids_ok[:, None], at), write


def trajectories(mesh: Mesh, snaps, seeds: np.ndarray, depths: np.ndarray,
                 traj: dict, ar: Arith = F64) -> dict:
    """The finalized lines of particles from ``seeds`` (N, 3) at float32
    ``depths``: {"points", "velocity"[, "attrs"]} as (N, R + 1, 3) float64
    host arrays.  One snapshot: a streamline; two: a pathline between
    them, recording up to two attributes when the front has more than one
    and the back at least one.  On a card the steps after the second
    replay one captured step (a CUDA graph): the same operations, launched
    at once."""
    pathline = len(snaps) == 2
    dev, real = mesh.cell_xyz.device, ar.dtype
    n_steps, n_rec, flags, slots, dt = schedule(traj, pathline)
    euler = traj.get("method", "rk4") == "euler"
    freeze = traj.get("fail_mode", "zero") == "freeze"
    n_attrs = 0
    if pathline and len(snaps[0].attr_names) > 1 and snaps[1].attrs is not None:
        n_attrs = min(len(snaps[0].attr_names), len(snaps[1].attr_names), 2)
    # each snapshot's tables as they are (no stacked copy of the whole
    # mesh); a step stacks the columns its particles gather
    tables = [[s.ztop.to(real) for s in snaps],
              [s.vel.to(real) for s in snaps],
              [s.wvel.to(real) for s in snaps],
              [s.attrs[..., :n_attrs].to(real) for s in snaps]
              if n_attrs else None]
    rmesh = dataclasses.replace(mesh, cell_xyz=mesh.cell_xyz.to(real))
    vxyz = mesh.vertex_xyz.to(real)

    n = len(seeds)
    cell = torch.as_tensor(nearest_cells(mesh, seeds), device=dev)
    st = _State(pos=torch.tensor(np.asarray(seeds, np.float64),
                                 device=dev).to(real),
                depth=torch.tensor(np.asarray(depths, np.float32),
                                   device=dev),
                cell=cell, alive=(cell >= 0) & (cell < mesh.n_cells))
    pts = torch.zeros((n, n_rec, 3), dtype=real, device=dev)
    pts[:, 0] = _where0(st.alive[:, None], st.pos)
    vels = torch.zeros_like(pts)
    attrs = torch.zeros_like(pts) if pathline else None
    # the stage alphas of every step (a pathline's time weights)
    t = np.float32 if real == torch.float32 else np.float64
    dalpha = t(dt) / t(int(traj["duration"]))
    a1 = np.asarray([t(i / n_steps) for i in range(n_steps)], dtype=t)
    table = np.stack([a1, np.clip(a1 + t(0.5) * dalpha, t(0), t(1)),
                      np.clip(a1 + dalpha, t(0), t(1))], axis=1) \
        if pathline else np.zeros((n_steps, 3), dtype=t)
    alpha_all = torch.as_tensor(table, device=dev)
    alpha = alpha_all[0].clone()

    def advance(i):
        return _advance(rmesh, tables, vxyz, st, tuple(alpha), dt, euler,
                        freeze, pathline, i > 0, ar)

    def record(i, out):
        hv, at, write = out
        upd = write[:, None]
        recs = [(vels, hv)] + ([(attrs, at)] if pathline else [])
        if i == 0:
            for buf, val in recs:
                buf[:, 0] = torch.where(upd, val, buf[:, 0])
        if flags[i]:
            s = int(slots[i])
            pts[:, s] = torch.where(upd, st.pos, pts[:, s])
            for buf, val in recs:
                buf[:, s] = torch.where(upd, val, buf[:, s])

    graph = None
    for i in range(n_steps):
        alpha.copy_(alpha_all[i])
        if graph is not None:
            graph.replay()
        elif dev.type == "cuda" and i == 1 and n_steps > 2:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                out = advance(i)            # the warm-up run is step 1
            torch.cuda.current_stream(dev).wait_stream(side)
            record(i, out)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = advance(i)            # captured, not run
            continue
        else:
            out = advance(i)
        record(i, out)
    return finalize(np.asarray(seeds, np.float64), pts.double().cpu().numpy(),
                    vels.double().cpu().numpy(),
                    None if attrs is None else attrs.double().cpu().numpy())


def finalize(seeds, points, velocities, attrs=None) -> dict:
    """Lines from (N, R, 3) records: the seed then R points; R velocities
    then a zero; cut at the first non-finite point, which and every later
    point take the last finite one, their velocities (from the one before)
    zero (reference RemoveNaNTrajectoriesAndReindex)."""
    n, n_rec = points.shape[:2]
    pts = np.concatenate([seeds[:, None, :], points], axis=1)
    vel = np.concatenate([velocities, np.zeros((n, 1, 3))], axis=1)
    bad = ~np.isfinite(pts).all(axis=2)
    cut = np.where(bad.any(axis=1), bad.argmax(axis=1), n_rec + 1)
    idx = np.arange(n_rec + 1)[None, :]
    keep = np.maximum(np.minimum(idx, cut[:, None] - 1), 0)
    pts = np.take_along_axis(pts, keep[..., None], axis=1)
    zero = (idx >= np.maximum(cut - 1, 0)[:, None]) & (cut <= n_rec)[:, None]
    vel = np.where(zero[..., None], 0.0, vel)
    out = {"points": pts, "velocity": vel}
    if attrs is not None:
        out["attrs"] = np.concatenate([attrs, np.zeros((n, 1, 3))], axis=1)
    return out


# ---------------------------------------------------------------------------
# fixed-depth remap
# ---------------------------------------------------------------------------

def pixel_xyz(image: dict, rows) -> np.ndarray:
    """(len(rows) * W, 3) float64 centres of the pixels of ``rows``: row i
    at lat max - i / H * (max - min), column j at lon min + j / W * (max -
    min)."""
    w, h = int(image["width"]), int(image["height"])
    (lat0, lat1), (lon0, lon1) = image["lat_range"], image["lon_range"]
    ii = np.repeat(np.asarray(rows, np.float64), w)
    jj = np.tile(np.arange(w, dtype=np.float64), len(rows))
    lat = np.deg2rad(lat1 - ii / h * (lat1 - lat0))
    lon = np.deg2rad(jj / w * (lon1 - lon0) + lon0)
    c = np.cos(lat)
    return EARTH_RADIUS * np.stack([c * np.cos(lon), c * np.sin(lon),
                                    np.sin(lat)], axis=-1)


def remap_rows(mesh: Mesh, snap: Snapshot, image: dict, rows,
               ar: Arith = F64, chunk: int = 1 << 18):
    """Rows of the fixed-depth image (reference TBB VisualizeFixedDepth with
    its layer-0 override): (velocity (n, W, 3) of east, north, speed;
    attribute groups (n, W, 3 * ceil(A / 3)) or None), NaN outside."""
    dev, real = mesh.cell_xyz.device, ar.dtype
    pix = pixel_xyz(image, rows)
    cells = torch.as_tensor(nearest_cells(mesh, pix), device=dev)
    pix = torch.as_tensor(pix, device=dev).to(real)
    depth = -float(image["depth"])
    vx = mesh.vertex_xyz.to(real)
    ztop, vel = snap.ztop.to(real), snap.vel.to(real)
    attrs = None if snap.attrs is None else snap.attrs.to(real)
    vel_out, att_out = [], []
    for s in range(0, pix.shape[0], chunk):
        pos, cell = pix[s:s + chunk], cells[s:s + chunk]
        n = pos.shape[0]
        ok_cell = (cell >= 0) & (cell < mesh.n_cells)
        vids, nv, vids_ok = cell_vertices(mesh, torch.where(ok_cell, cell, 0))
        vpos = vx[vids]
        lane_valid = torch.arange(vids.shape[1], device=dev)[None, :] \
            < nv[:, None]
        inside = in_mesh(pos, vpos, nv, lane_valid) & ok_cell & vids_ok
        w = wachspress(pos, vpos, nv)
        z = clamp_profile(ar.wsum("nk,nkl->nl", w, ztop[vids]))
        L = z.shape[1]
        dn = torch.full((n,), depth, dtype=real, device=dev)
        z_surf, z_bot = torch.maximum(z[:, 0], z[:, -1]), \
            torch.minimum(z[:, 0], z[:, -1])
        epsd = (1e-8 * (z_surf - z_bot).abs()).clamp(min=1e-6)
        in_col = (dn <= z_surf + epsd) & (dn >= z_bot - epsd)
        top = torch.maximum(z[:, :-1], z[:, 1:])
        bot = torch.minimum(z[:, :-1], z[:, 1:])
        cond = (dn[:, None] <= top + 1e-8) & (dn[:, None] >= bot - 1e-8)
        layer = torch.where(cond.any(1), torch.argmax(
            cond.to(torch.uint8), dim=1) + 1, -1)
        layer = torch.where(dn <= z[:, 0], 0, layer)
        ok = inside & in_col & (layer >= 0)
        layer = layer.clamp(0, L - 1)
        top_i = z.gather(1, (layer - 1).clamp(min=0)[:, None])[:, 0]
        bot_i = z.gather(1, layer[:, None])[:, 0]
        top_s, bot_s = torch.maximum(top_i, bot_i), torch.minimum(top_i,
                                                                  bot_i)
        denom = top_s - bot_s
        tt = torch.where(denom > 1e-12, (dn - bot_s) / torch.where(
            denom == 0, torch.ones_like(denom), denom),
            torch.full_like(denom, 0.5))
        jt = (layer - 1).clamp(0, L - 1)
        jb = (jt + 1).clamp(max=L - 1)

        def at_layer(table, j):
            g = table[vids, j[:, None]]
            return ar.wsum("nk,nkc->nc" if g.ndim == 3 else "nk,nk->n", w, g)
        v_top, v_bot = at_layer(vel, jt), at_layer(vel, jb)
        top0 = (_norm(v_top) < 1e-12)[:, None]
        bot0 = (_norm(v_bot) < 1e-12)[:, None]
        lerp = (1.0 - tt[:, None]) * v_bot + tt[:, None] * v_top
        final = torch.where(top0 & bot0, torch.zeros_like(lerp),
                            torch.where(top0, v_bot,
                                        torch.where(bot0, v_top, lerp)))
        ue, vn = xyz_to_enu(pos, final)
        img = torch.stack([ue, vn, torch.sqrt(ue ** 2 + vn ** 2)], dim=-1)
        nan = torch.full_like(img, float("nan"))
        vel_out.append(torch.where(ok[:, None], img, nan))
        if attrs is not None:
            aj = (layer - 1).clamp(0, attrs.shape[1] - 1)
            vals = [at_layer(attrs[..., a], aj)
                    for a in range(min(attrs.shape[-1], 8))]
            while len(vals) % 3:
                vals.append(torch.zeros_like(ue))
            a_img = torch.stack(vals, dim=-1)
            att_out.append(torch.where(ok[:, None], a_img,
                                       torch.full_like(a_img, float("nan"))))
    W = int(image["width"])
    velocity = torch.cat(vel_out).double().cpu().numpy().reshape(-1, W, 3)
    groups = None if attrs is None else torch.cat(att_out).double().cpu() \
        .numpy().reshape(len(rows), W, -1)
    return velocity, groups
