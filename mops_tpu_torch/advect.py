"""Streamline and pathline advection on tensors: a Python loop over steps
(mirror of the single-device paths of mops_tpu.advect).

Reference semantics (reference src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp
:668-1496, the golden baseline): every per-particle branch (containment
test, layer search, zero-velocity exits, neighbour-walk relocation) is
masked arithmetic over the whole particle batch.

Step pipeline:
  relocate (not on step 0) -> gather the cell's vertex ids -> one fused
  RK4/Euler step (a CUDA kernel, or its plain torch version in step.py)
  -> depth/radius update -> strided record into the (N, R, 3) buffers.

On the card the step reads only a W-layer window of each column by default
(mops_tpu's layer-window path, pallas/window_kernel.py): each particle
carries the layer of its last step, the window starts W/2 - 1 layers above
it, and a particle whose depth nears an inner window edge is stepped on the
full column inside the same kernel, so the trajectories are the full
step's.

Exact-parity quirks kept: cell relocation once per outer step with the cell
frozen across RK stages; ztop clamp z[k] -> z[k-1] - 1e-9; binary layer
search (streamline) or first-hit linear search (pathline); zero guards at
1e-12; RK4 endpoint renormalized to the pre-step radius; depth (positive
down) decremented while the radius grows by w*dt; particle depth carried as
float32 like the reference's effective_depths; pathline stage alphas
(a1, a1 + dalpha/2, a1 + dalpha) clipped to [0, 1].
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .config import EPS_ZERO
from .interp import wachspress_weights
from .kernels.stage_kernel import (fused_pathline_step,
                                   fused_pathline_step_plain,
                                   fused_streamline_step,
                                   fused_streamline_step_plain,
                                   fused_window_pathline_step,
                                   fused_window_streamline_step,
                                   pack_vertex_table)
from .mesh import MPASMesh, resolve_device
from .settings import CalcDirection, CalcMethod, FailMode, TrajectorySettings
from .solution import SolutionFields
from .step import (_clamp_profile, _layer_search_binary, _norm, _where0,
                   window_starts)

# Layers a window holds (mops_tpu's MOPS_WINDOW_W default).
WINDOW_LAYERS = 8


# ---------------------------------------------------------------------------
# geometry helpers (full batch)
# ---------------------------------------------------------------------------

def _gather_cell_vertices(mesh: MPASMesh, cell: torch.Tensor):
    """vids (clipped to >= 0), nv and vids_ok for each particle's current
    cell; vids_ok is false where a vertex id below nv is absent (-1)."""
    c = cell.long()
    vids_raw = mesh.vertices_on_cell[c]                  # (N, K) int32
    nv = mesh.n_edges_on_cell[c]                         # (N,) int32
    K = vids_raw.shape[1]
    lane_valid = torch.arange(K, device=c.device)[None, :] < nv[:, None]
    vids_ok = torch.all(~lane_valid | (vids_raw >= 0), dim=1)
    return torch.clamp(vids_raw, min=0), nv, vids_ok


def build_reloc_xyz(mesh: MPASMesh) -> torch.Tensor:
    """(nC, K+1, 3) candidate positions for the relocation argmin: lanes
    0..K-1 = cellsOnCell neighbour centers (+inf where the neighbour is
    absent, so its distance is +inf), lane K = the cell's own center."""
    coc = mesh.cells_on_cell
    cx = mesh.cell_xyz
    valid = (coc >= 0) & (coc < mesh.n_cells)
    nb = cx[torch.clamp(coc, 0, mesh.n_cells - 1).long()]
    nb = torch.where(valid[..., None], nb, torch.full_like(nb, float("inf")))
    return torch.cat([nb, cx[:, None, :]], dim=1)


def _relocate_rows(row: torch.Tensor, coc: torch.Tensor, nv: torch.Tensor,
                   pos: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Argmin over {neighbours, self} from pre-gathered candidate rows
    (row (N, K+1, 3), coc (N, K), nv (N,)).  The candidate order (neighbours
    at lanes < nv, self at lane nv, rest invalid) and torch.argmin's
    first-minimum tie-break are those of GetCellNeighborsIdx (reference
    SYCLKernel.cpp:79-98)."""
    K = row.shape[1] - 1
    lane = torch.arange(K + 1, device=pos.device)[None, :]
    nvl = nv[:, None].long()
    d2 = torch.sum((row - pos[:, None, :]) ** 2, dim=-1)  # (N, K+1)
    d2 = torch.where(lane == nvl, d2[:, K:],
                     torch.where(lane >= nvl, float("inf"), d2))
    best = torch.argmin(d2, dim=1)
    pick = coc.gather(1, torch.clamp(best, max=K - 1)[:, None])[:, 0]
    return torch.where(best == nv.long(), cell, pick)


def _relocate_packed(mesh: MPASMesh, reloc_xyz: torch.Tensor,
                     pos: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """_relocate_rows driven by per-cell gathers from the mesh tables."""
    c = cell.long()
    return _relocate_rows(reloc_xyz[c], mesh.cells_on_cell[c],
                          mesh.n_edges_on_cell[c], pos, cell)


# ---------------------------------------------------------------------------
# the step loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RawTrajectories:
    """Device-side advection output, pre-finalization.

    points/velocities/attrs are the reference's flat record buffers reshaped
    to (N, R, 3) (slot 0 pre-seeded with the start position, see
    src/Common/TrajectoryCommon.h:15-27 + TBB kernel :901).  attrs is the
    pathline's record of up to two named attributes (zeros without them),
    None for a streamline.  window_misses counts, per particle, the steps
    whose layer window missed (alive lanes with valid vertex ids); None
    when the run used no window.
    """

    points: torch.Tensor           # (N, R, 3)
    velocities: torch.Tensor       # (N, R, 3)
    attrs: Optional[torch.Tensor]  # (N, R, 3) or None
    final_position: torch.Tensor   # (N, 3)
    final_depth: torch.Tensor      # (N,) float32
    final_cell: torch.Tensor       # (N,) int32
    alive: torch.Tensor            # (N,) bool
    window_misses: Optional[torch.Tensor] = None   # (N,) int32


def record_schedule(settings: TrajectorySettings, pathline: bool):
    """Per-step (record_flag, record_slot) numpy arrays.

    Streamline records when run_time %% recordT == 0 with run_time = (i+1)*|dt|
    (reference TBB kernel :994); pathline when (i+1) %% (recordT/deltaT) == 0
    (TBB kernel :1470-1471).  Slots beyond R are dropped like the reference's
    bound check."""
    n_steps = settings.n_steps
    n_rec = settings.n_records
    i = np.arange(n_steps)
    if pathline:
        interval = int(settings.record_t) // int(settings.delta_t)
        flags = np.zeros(n_steps, dtype=bool) if interval <= 0 \
            else ((i + 1) % interval == 0)
    else:
        run_time = (i + 1) * abs(int(settings.delta_t))
        flags = (run_time % int(settings.record_t)) == 0
    slots = np.where(flags, np.cumsum(flags) - 1, 0).astype(np.int32)
    flags = flags & (slots < n_rec)
    return flags, slots


def stacked_vertex_attrs(sol: SolutionFields) -> Optional[torch.Tensor]:
    """Vertex attributes stacked (nV, L, A) in lexicographic name order,
    mirroring the reference's std::map iteration order
    (src/GPU/SYCL/MPASOVisualizerSYCL.cpp:231-235)."""
    if len(sol.vertex_attrs) == 0:
        return None
    return torch.stack([sol.vertex_attrs[k] for k in sorted(sol.vertex_attrs)],
                       dim=-1)


def advection_schedule(settings: TrajectorySettings, pathline: bool):
    """Host (is_first, flags, slots, alphas) arrays + the signed dt.  The
    pathline alphas are i / n_steps in float64 (zeros for a streamline);
    the caller casts them to the run dtype."""
    n_steps = settings.n_steps
    flags, slots = record_schedule(settings, pathline)
    is_first = np.arange(n_steps) == 0
    alphas = (np.arange(n_steps) / n_steps).astype(np.float64) if pathline \
        else np.zeros(n_steps)
    sign = 1 if settings.direction == CalcDirection.FORWARD else -1
    return is_first, flags, slots, alphas, float(sign * int(settings.delta_t))


def stage_alphas(alpha, dt: float, duration: int, real: torch.dtype):
    """(a1, a2, a4) of one pathline step in the run dtype: a1 = alpha,
    a2 = clip(a1 + dalpha/2, 0, 1), a4 = clip(a1 + dalpha, 0, 1) with the
    signed dalpha = dt / duration (reference TBB kernel :1784-1819)."""
    t = np.float32 if real == torch.float32 else np.float64
    a1 = t(alpha)
    dalpha = t(dt) / t(duration)
    return (a1, np.clip(a1 + t(0.5) * dalpha, t(0), t(1)),
            np.clip(a1 + dalpha, t(0), t(1)))


def run_advection(mesh: MPASMesh, front: SolutionFields,
                  seeds, cells, settings: TrajectorySettings,
                  back: Optional[SolutionFields] = None,
                  exact_clamp: bool = True,
                  dtype: Optional[torch.dtype] = None,
                  use_kernel: bool = True,
                  device="cuda",
                  use_window: Optional[bool] = None,
                  window: int = WINDOW_LAYERS) -> RawTrajectories:
    """Run a full streamline (back=None) or pathline advection on ``device``:
    the card unless the caller passes device="cpu" (without a card a CUDA
    request raises).  The mesh and solution tables are moved there and cast
    to the run dtype (``dtype``, default the mesh's).

    Mirrors the reference host orchestration: buffer setup per
    Common::InitTrajectoryOutputBuffers (src/Common/TrajectoryCommon.h:15-27),
    per-particle float32 depths per BuildEffectiveDepths (:29-41), then the
    step loop.  ``seeds``/``cells`` are host arrays of the sample positions
    and their KD-searched start cells (-1 marks a dead particle).  A
    pathline blends ``front`` and ``back`` by the run's time fraction and
    carries up to two named attributes when both snapshots have them
    (mops_tpu's gate: front has more than one, back at least one).

    ``use_kernel`` routes each step through the fused step kernel
    (kernels/stage_kernel.py: the CUDA kernel for CUDA tensors, its plain
    version on the CPU); False runs the plain version on any device, the
    reference the kernel is gated against.  The kernels implement the
    sequential clamp only, so they require ``exact_clamp``.

    ``use_window`` routes the kernel path through the layer-window kernels
    (fused_window_*_step) with windows of min(L, max(4, ``window``))
    layers; None turns it on for a CUDA run with L > 2 (mops_tpu turns it on
    for compiled TPU runs), False keeps the full-column kernels.
    """
    pathline = back is not None
    if use_kernel and not exact_clamp:
        raise ValueError("the fused step kernel implements the sequential "
                         "(exact) ztop clamp only")
    device = resolve_device(device)
    real = mesh.dtype if dtype is None else dtype
    n = len(seeds)
    n_steps, n_rec = settings.n_steps, settings.n_records
    if n_steps <= 0 or n_rec <= 0:
        raise ValueError("invalid integration steps "
                         f"(n_steps={n_steps}, n_records={n_rec})")

    # mesh + solution tables on the device in the particle dtype (no-ops
    # when they agree)
    mesh = mesh.to(device, real)
    front = front.to(device, real)
    back = back.to(device, real) if pathline else None

    is_first, flags, slots, alphas, dt = advection_schedule(settings, pathline)
    duration = int(settings.simulation_duration)
    euler = settings.method == CalcMethod.EULER
    freeze = settings.fail_mode == FailMode.FREEZE

    pos = torch.as_tensor(np.array(seeds), device=device).to(real)
    cell = torch.as_tensor(np.array(cells), device=device).to(torch.int32)
    depth = torch.as_tensor(settings.effective_depths(n), device=device)
    alive = (cell >= 0) & (cell < mesh.n_cells)

    pts = torch.zeros((n, n_rec, 3), dtype=real, device=device)
    vels = torch.zeros_like(pts)
    attrs = torch.zeros_like(pts) if pathline else None
    # first_loop pre-seeds slot 0 with the start position (TBB kernel :901)
    pts[:, 0] = _where0(alive[:, None], pos)

    reloc_xyz = build_reloc_xyz(mesh)
    n_layers = front.vertex_ztop.shape[1]
    n_attrs = 0
    attr_f = attr_b = None
    if pathline and len(front.cell_attrs) > 1 and len(back.cell_attrs) > 0:
        attr_f, attr_b = stacked_vertex_attrs(front), stacked_vertex_attrs(back)
        n_attrs = min(attr_f.shape[-1], attr_b.shape[-1], 2)
        attr_f, attr_b = attr_f[..., :n_attrs], attr_b[..., :n_attrs]
    windowed = use_kernel and (device.type == "cuda" and n_layers > 2
                               if use_window is None else bool(use_window))
    n_window = min(n_layers, max(4, int(window)))
    misses = None
    if windowed:
        # the first window sits around the seeds' layer (a full-column
        # binary search, as mops_tpu seeds its window hint)
        vids0, nv0, _ = _gather_cell_vertices(mesh, torch.clamp(cell, min=0))
        w0 = wachspress_weights(pos, mesh.vertex_xyz[vids0.long()], nv0)
        z0 = _clamp_profile(torch.einsum(
            "nk,nkl->nl", w0, front.vertex_ztop[vids0.long()]), True)
        layer = _layer_search_binary(z0, (-depth).to(real)).to(torch.int32)
        misses = torch.zeros(n, dtype=torch.int32, device=device)
    table = pack_vertex_table(mesh.vertex_xyz, front.vertex_ztop,
                              front.vertex_velocity,
                              front.vertex_vert_velocity, attr_f)
    if pathline:
        table_b = pack_vertex_table(mesh.vertex_xyz, back.vertex_ztop,
                                    back.vertex_velocity,
                                    back.vertex_vert_velocity, attr_b)
        pstep = fused_pathline_step if use_kernel else functools.partial(
            fused_pathline_step_plain, exact_clamp=exact_clamp)
    else:
        step = fused_streamline_step if use_kernel else functools.partial(
            fused_streamline_step_plain, exact_clamp=exact_clamp)

    for i in range(n_steps):
        depth_neg = (-depth).to(real)
        if not is_first[i]:
            new_cell = _relocate_packed(mesh, reloc_xyz, pos, cell)
            cell = torch.where(alive, new_cell, cell)
        vids, nv, vids_ok = _gather_cell_vertices(mesh, cell)
        if windowed:
            s = window_starts(layer, n_layers, n_window)
            if pathline:
                np_k, hv_k, wv_k, ok_k, layer_k, miss, at_k = \
                    fused_window_pathline_step(
                        pos, depth_neg, nv, vids, s, table, table_b,
                        n_layers, n_window, dt,
                        stage_alphas(alphas[i], dt, duration, real),
                        euler=euler, n_attrs=n_attrs)
            else:
                np_k, hv_k, wv_k, ok_k, layer_k, miss = \
                    fused_window_streamline_step(
                        pos, depth_neg, nv, vids, s, table, n_layers,
                        n_window, dt, euler=euler)
                at_k = None
            layer = torch.where(alive, layer_k, layer)
            misses += (miss & alive & vids_ok).to(torch.int32)
        elif pathline:
            np_k, hv_k, wv_k, ok_k, at_k = pstep(
                pos, depth_neg, nv, vids, table, table_b, n_layers, dt,
                stage_alphas(alphas[i], dt, duration, real), euler=euler,
                n_attrs=n_attrs)
        else:
            np_k, hv_k, wv_k, ok_k = step(pos, depth_neg, nv, vids, table,
                                          n_layers, dt, euler=euler)
            at_k = None
        # invalid vertex ids (reference R_VLA_FAIL) are checked outside the
        # step: zero the velocities and attributes and keep the position
        step_ok = ok_k & vids_ok
        hvel = _where0(vids_ok[:, None], hv_k)
        wvel = _where0(vids_ok, wv_k)
        new_pos = torch.where(vids_ok[:, None], np_k, pos)

        write_ok = (alive & step_ok) if freeze else alive
        alive = write_ok

        r = _norm(pos)
        new_depth = torch.clamp(depth.to(real) - wvel * dt, min=0.0)
        r_new = torch.clamp(r + wvel * dt, min=1.0)
        nlen = _norm(new_pos)
        new_pos = torch.where(
            (nlen > EPS_ZERO)[:, None],
            new_pos / torch.where(nlen == 0.0, torch.ones_like(nlen),
                                  nlen)[:, None] * r_new[:, None],
            new_pos)

        pos = torch.where(write_ok[:, None], new_pos, pos)
        depth = torch.where(write_ok, new_depth.to(depth.dtype), depth)

        # first-step velocity/attr into slot 0 (TBB kernel :988-991); the
        # attribute buffer stays zero without attributes
        upd = write_ok[:, None]
        records = [(vels, hvel)]
        if at_k is not None:
            records.append((attrs, _where0(vids_ok[:, None], at_k)))
        if is_first[i]:
            for buf, val in records:
                buf[:, 0] = torch.where(upd, val, buf[:, 0])
        if flags[i]:
            s = int(slots[i])
            pts[:, s] = torch.where(upd, pos, pts[:, s])
            for buf, val in records:
                buf[:, s] = torch.where(upd, val, buf[:, s])

    return RawTrajectories(points=pts, velocities=vels, attrs=attrs,
                           final_position=pos, final_depth=depth,
                           final_cell=cell, alive=alive,
                           window_misses=misses)
