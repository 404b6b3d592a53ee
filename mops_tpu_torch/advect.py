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
it, and a particle whose depth nears an inner window edge (an edge miss),
or whose window may not clamp or test the surface and bottom as the full
column does (a clamp miss, step.py), is stepped again on the full column
right after on the same stream, so the trajectories are the full step's.

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
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .config import EPS_ZERO
from .interp import wachspress_weights
from .kernels.stage_kernel import (column_instance, fused_pathline_step,
                                   fused_pathline_step_plain,
                                   fused_streamline_step,
                                   fused_streamline_step_plain,
                                   fused_window_pathline_step,
                                   fused_window_streamline_step,
                                   count_launches, held_counts,
                                   pack_vertex_table, table_rise)
from .mesh import MPASMesh, resolve_device
from .settings import CalcDirection, CalcMethod, FailMode, TrajectorySettings
from .solution import SolutionFields
from .step import (_clamp_profile, _layer_search_binary,
                   _layer_search_linear, _norm, _where0, window_starts)
from .utils.timer import Phases, TimerManager, timer

# Layers a window holds (mops_tpu's MOPS_WINDOW_W default).
WINDOW_LAYERS = 8

# The path the most recent run_advection call took (mops_tpu.advect's
# LAST_RESOLVED, without its TPU table-layout keys): ``kernel`` the step
# kernel each step launches ("k1".."k4"; on CPU tensors its plain version
# stands in) or None on the plain path, ``window``/``n_window`` the layer
# window, ``pathline``, ``n_attrs``, ``dtype``, ``instance`` the K1/K2
# instance the step or its repair launches ("64" or "generic",
# stage_kernel.column_instance; None on the plain path).  Tooling (the
# bench) reads it instead of re-deriving the decision; the bench adds the
# step's least bytes itself (step_cost, a pass over every particle), after
# its timed run.
LAST_RESOLVED: dict = {}

# Particles step_cost takes at a time: bounds its (chunk, K, L) gathers.
_COST_CHUNK = 1 << 18

# The phases of a step, in order (advance; spans of run_advection's detail).
PHASES = ("advect.relocate", "advect.gather", "advect.step", "advect.update",
          "advect.record")


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
    whose layer window missed (alive lanes with valid vertex ids), and
    window_clamp_misses those of them that only the clamp test flagged
    (the rest are edge misses); both None when the run used no window.
    """

    points: torch.Tensor           # (N, R, 3)
    velocities: torch.Tensor       # (N, R, 3)
    attrs: Optional[torch.Tensor]  # (N, R, 3) or None
    final_position: torch.Tensor   # (N, 3)
    final_depth: torch.Tensor      # (N,) float32
    final_cell: torch.Tensor       # (N,) int32
    alive: torch.Tensor            # (N,) bool
    window_misses: Optional[torch.Tensor] = None   # (N,) int32
    window_clamp_misses: Optional[torch.Tensor] = None   # (N,) int32


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
    signed dalpha = dt / duration (reference TBB kernel :1784-1819).
    ``alpha`` may be an array of steps' alphas: each of a1, a2 and a4 is
    then an array, elementwise the same values."""
    t = np.float32 if real == torch.float32 else np.float64
    a1 = np.asarray(alpha).astype(t)[()]
    dalpha = t(dt) / t(duration)
    return (a1, np.clip(a1 + t(0.5) * dalpha, t(0), t(1)),
            np.clip(a1 + dalpha, t(0), t(1)))


def pathline_attrs(front: SolutionFields,
                   back: Optional[SolutionFields] = None):
    """(front stack, back stack, n_attrs) of the named attributes a run
    records: up to two, on a pathline whose snapshots both have them
    (mops_tpu's gate: front has more than one, back at least one); else
    (None, None, 0)."""
    if back is None or len(front.cell_attrs) <= 1 \
            or len(back.cell_attrs) == 0:
        return None, None, 0
    attr_f, attr_b = stacked_vertex_attrs(front), stacked_vertex_attrs(back)
    n_attrs = min(attr_f.shape[-1], attr_b.shape[-1], 2)
    return attr_f[..., :n_attrs], attr_b[..., :n_attrs], n_attrs


def snapshot_tables(mesh: MPASMesh, front: SolutionFields,
                    back: Optional[SolutionFields] = None):
    """(table, table_b or None, n_attrs): the packed vertex tables of the
    front (and back) snapshot with pathline_attrs' attributes."""
    attr_f, attr_b, n_attrs = pathline_attrs(front, back)
    table = pack_vertex_table(mesh.vertex_xyz, front.vertex_ztop,
                              front.vertex_velocity,
                              front.vertex_vert_velocity, attr_f)
    table_b = None if back is None else pack_vertex_table(
        mesh.vertex_xyz, back.vertex_ztop, back.vertex_velocity,
        back.vertex_vert_velocity, attr_b)
    return table, table_b, n_attrs


class StepOut(NamedTuple):
    """One fused step's outputs, the same record in every form (the window
    wrappers' order): ``layer`` (the layer at the start position),
    ``miss`` and ``clamp`` None without a window, ``attr`` None but on a
    pathline with attributes."""

    new_pos: torch.Tensor
    hvel: torch.Tensor
    wvel: torch.Tensor
    ok: torch.Tensor
    layer: Optional[torch.Tensor] = None
    miss: Optional[torch.Tensor] = None
    clamp: Optional[torch.Tensor] = None
    attr: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class Stepper:
    """What a step needs besides the particles: one mesh's tables on one
    device (the whole mesh, or a shard's local tables) and the run's
    settings.  ``n_window`` is the layer window's width, 0 for the
    full-column step; ``rise`` and ``rise_b`` are the window kernels'
    first rises of ``table`` and ``table_b`` (stage_kernel.table_rise; None
    without a window or a back snapshot).  ``kernel`` is the step kernel
    each step launches ("k1".."k4"; on CPU tensors its plain version stands
    in), None for the plain step; ``step(pos, depth_neg, nv, vids, s,
    alphas)`` runs that step with the tables and settings bound and
    returns a StepOut (``s`` the window starts, ``alphas`` the step's entry
    of ``alphas``).  ``alphas`` holds each step's stage alphas (a1, a2, a4)
    in the run dtype on a pathline, None on a streamline."""

    mesh: MPASMesh
    reloc_xyz: torch.Tensor
    table: torch.Tensor
    table_b: Optional[torch.Tensor]
    n_layers: int
    n_attrs: int
    n_window: int
    kernel: Optional[str]
    step: Callable[..., StepOut]
    freeze: bool
    dt: float
    is_first: np.ndarray
    flags: np.ndarray
    slots: np.ndarray
    alphas: list
    rise: Optional[torch.Tensor] = None
    rise_b: Optional[torch.Tensor] = None

    @property
    def pathline(self) -> bool:
        return self.table_b is not None


def _step_form(use_kernel, exact_clamp, table, table_b, rise, rise_b,
               n_layers, n_window, n_attrs, dt, euler):
    """(kernel, step) of make_stepper: the step's form, picked once; each
    step calls its wrapper or plain version by its module name."""
    L, W, A, tb = n_layers, n_window, n_attrs, table_b
    if W and tb is None:
        return "k3", lambda pos, dn, nv, vids, s, alphas: StepOut(
            *fused_window_streamline_step(pos, dn, nv, vids, s, table, rise,
                                          L, W, dt, euler))
    if W:
        return "k4", lambda pos, dn, nv, vids, s, alphas: StepOut(
            *fused_window_pathline_step(pos, dn, nv, vids, s, table, tb, rise,
                                        rise_b, L, W, dt, alphas, euler, A))
    if tb is None and use_kernel:
        return "k1", lambda pos, dn, nv, vids, s, alphas: StepOut(
            *fused_streamline_step(pos, dn, nv, vids, table, L, dt, euler))
    if tb is None:
        return None, lambda pos, dn, nv, vids, s, alphas: StepOut(
            *fused_streamline_step_plain(pos, dn, nv, vids, table, L, dt,
                                         euler, exact_clamp))

    def k2(pos, dn, nv, vids, s, alphas):
        *out, attr = fused_pathline_step(pos, dn, nv, vids, table, tb, L, dt,
                                         alphas, euler, A)
        return StepOut(*out, attr=attr)

    def plain(pos, dn, nv, vids, s, alphas):
        *out, attr = fused_pathline_step_plain(pos, dn, nv, vids, table, tb, L,
                                               dt, alphas, euler, A,
                                               exact_clamp)
        return StepOut(*out, attr=attr)
    return ("k2", k2) if use_kernel else (None, plain)


def make_stepper(mesh: MPASMesh, table, table_b, n_attrs: int,
                 settings: TrajectorySettings, use_kernel: bool = True,
                 exact_clamp: bool = True, n_window: int = 0) -> Stepper:
    """A Stepper over ``mesh`` and packed tables already on one device in
    the run dtype: the step's form (K1-K4 by the back table and the
    window, or the plain step without ``use_kernel``) picked here, and the
    schedule's stage alphas and, with a window, each table's first rises
    computed here, once."""
    if use_kernel and not exact_clamp:
        raise ValueError("the fused step kernel implements the sequential "
                         "(exact) ztop clamp only")
    if n_window and not use_kernel:
        raise ValueError("the layer window is a kernel path")
    pathline = table_b is not None
    is_first, flags, slots, alphas, dt = advection_schedule(settings, pathline)
    stage = list(zip(*stage_alphas(alphas, dt,
                                   int(settings.simulation_duration),
                                   table.dtype))) if pathline \
        else [None] * len(alphas)
    n_layers = (table.shape[1] - 4) // (5 + n_attrs)
    rise, rise_b = (None if not n_window or t is None
                    else table_rise(t, n_layers) for t in (table, table_b))
    euler = settings.method == CalcMethod.EULER
    kernel, step = _step_form(use_kernel, exact_clamp, table, table_b, rise,
                              rise_b, n_layers, n_window, n_attrs, dt, euler)
    return Stepper(mesh=mesh, reloc_xyz=build_reloc_xyz(mesh), table=table,
                   table_b=table_b, n_layers=n_layers, n_attrs=n_attrs,
                   n_window=n_window, kernel=kernel, step=step,
                   freeze=settings.fail_mode == FailMode.FREEZE, dt=dt,
                   is_first=is_first, flags=flags, slots=slots, alphas=stage,
                   rise=rise, rise_b=rise_b)


@dataclasses.dataclass
class Particles:
    """A batch of particles on one device and their record buffers, which
    ``advance`` updates in place.  ``layer`` is the window path's carried
    layer, ``misses`` its per-particle window-miss count and
    ``clamp_misses`` the part of it that only the clamp test flagged (None
    on the full-column path).  ``pid`` and ``rec_ids`` tag a migrating pool's
    slots and records with particle ids (-1: empty slot, no record)."""

    pos: torch.Tensor              # (N, 3) run dtype
    depth: torch.Tensor            # (N,) float32
    cell: torch.Tensor             # (N,) int32
    alive: torch.Tensor            # (N,) bool
    pts: torch.Tensor              # (N, R, 3)
    vels: torch.Tensor             # (N, R, 3)
    attrs: Optional[torch.Tensor]  # (N, R, 3) on a pathline
    layer: Optional[torch.Tensor] = None
    misses: Optional[torch.Tensor] = None
    clamp_misses: Optional[torch.Tensor] = None
    pid: Optional[torch.Tensor] = None
    rec_ids: Optional[torch.Tensor] = None

    def raw(self) -> RawTrajectories:
        return RawTrajectories(points=self.pts, velocities=self.vels,
                               attrs=self.attrs, final_position=self.pos,
                               final_depth=self.depth, final_cell=self.cell,
                               alive=self.alive, window_misses=self.misses,
                               window_clamp_misses=self.clamp_misses)


def seed_layers(mesh: MPASMesh, vertex_ztop: torch.Tensor, pos, cell,
                depth) -> torch.Tensor:
    """The layer window's first centre: a full-column binary layer search
    at each start position (as mops_tpu seeds its window hint)."""
    vids, nv, _ = _gather_cell_vertices(mesh, torch.clamp(cell, min=0))
    w = wachspress_weights(pos, mesh.vertex_xyz[vids.long()], nv)
    z = _clamp_profile(torch.einsum("nk,nkl->nl", w,
                                    vertex_ztop[vids.long()]), True)
    return _layer_search_binary(z, (-depth).to(pos.dtype)).to(torch.int32)


def step_cost(mesh: MPASMesh, sols, seeds, cells, depths, n_attrs: int = 0,
              n_window: int = 0):
    """The least bytes one fused step must move and the operations it does,
    at the start inputs ``seeds``, ``cells`` and ``depths`` of a run on
    ``mesh`` and its snapshots ``sols`` (one: a streamline; front and back:
    a pathline), all on one device in the run dtype: (bytes, operations).

    Bytes: each input read once and each output written once.  Vertex rows
    that several particles share count once: xyz (from the front table) and
    the ztop every vertex an alive particle's cell uses, in each snapshot
    (the whole column, or with ``n_window`` the window's layers at the start
    position's window start plus the surface and bottom values), plus the
    velocity (3), vertical velocity (1) and attribute values of each
    distinct (vertex, layer) pair that the layers above and below the
    particle's depth pick; pos, depth, nv and the nv vertex ids (and the
    window start); the outputs.  The layers are those at the start position
    (a stage whose position crosses a layer reads more, and a window miss
    reads the full column, so this is a lower bound).  Operations: the
    leading terms of the kernel's loops over four RK4 stages (geometry ~85
    per vertex; per snapshot the profile 2*nv*(L or W) and the picks
    2*nv*(8 + 2A)).  Particles are taken _COST_CHUNK at a time."""
    dev, real = mesh.device, mesh.dtype
    size = torch.finfo(real).bits // 8
    pathline = len(sols) == 2
    L = sols[0].vertex_ztop.shape[1]
    n = len(seeds)
    if n == 0:
        return 0, 0.0

    def union(acc, new):
        new = torch.unique(new)
        return new if acc is None else torch.unique(torch.cat([acc, new]))

    verts, keys, zkeys = None, [None] * len(sols), [None] * len(sols)
    ops, nv_sum = 0.0, 0
    for a in range(0, n, _COST_CHUNK):
        b = min(a + _COST_CHUNK, n)
        cell = torch.as_tensor(cells[a:b], device=dev)
        alive = (cell >= 0) & (cell < mesh.n_cells)
        vids, nv_cell, _ = _gather_cell_vertices(
            mesh, torch.clamp(cell, 0, mesh.n_cells - 1))
        nv = torch.where(alive, nv_cell, 0)
        valid = torch.arange(vids.shape[1], device=dev)[None, :] < nv[:, None]
        vid = vids.long()
        verts = union(verts, vid[valid])
        pos = torch.as_tensor(seeds[a:b], device=dev).to(real)
        dn = -torch.as_tensor(depths[a:b], device=dev).to(real)
        w = wachspress_weights(pos, mesh.vertex_xyz[vid], nv_cell)
        nvd = nv.double()
        nv_sum += int(nv.sum())
        lane_ops = 85 * nvd
        if n_window:
            z = _clamp_profile(torch.einsum("nk,nkl->nl", w,
                                            sols[0].vertex_ztop[vid]), True)
            s = window_starts(_layer_search_binary(z, dn), L, n_window).long()
            lw = s[:, None, None] + torch.arange(n_window, device=dev)
        for j, sol in enumerate(sols):
            z = _clamp_profile(torch.einsum("nk,nkl->nl", w,
                                            sol.vertex_ztop[vid]), True)
            layer = _layer_search_linear(z, dn)[0] if pathline \
                else _layer_search_binary(z, dn)
            keys[j] = union(keys[j], torch.cat(
                [(vid * L + (layer - 1)[:, None])[valid],
                 (vid * L + layer[:, None])[valid]]))
            if n_window:
                zkeys[j] = union(zkeys[j], (vid[:, :, None] * L + lw)[valid])
            lane_ops = lane_ops + 2 * nvd * ((n_window or L) + 8 + 2 * n_attrs)
        ops += 4 * float(lane_ops.sum())
    n_vert = int(verts.numel())
    nbytes = n_vert * 3 * size
    for j in range(len(sols)):
        nbytes += (int(zkeys[j].numel()) + 2 * n_vert if n_window
                   else n_vert * L) * size
        nbytes += int(keys[j].numel()) * (3 + 1 + n_attrs) * size
    nbytes += n * (4 * size + 4) + 4 * nv_sum                    # inputs
    nbytes += n * (7 * size + 1 + (3 * size if n_attrs else 0))  # outputs
    if n_window:
        nbytes += n * (4 + 4 + 1)                # start in; layer, miss out
    return nbytes, ops


def new_particles(st: Stepper, pos, cell, depth, n_records: int,
                  layer=None) -> Particles:
    """Particles at their start: ``cell`` -1 (or beyond the mesh) marks a
    dead particle; slot 0 of the points is pre-seeded with the start
    position (TBB kernel :901).  The window path needs ``layer``."""
    n = pos.shape[0]
    alive = (cell >= 0) & (cell < st.mesh.n_cells)
    pts = torch.zeros((n, n_records, 3), dtype=pos.dtype, device=pos.device)
    pts[:, 0] = _where0(alive[:, None], pos)
    misses = clamp_misses = None
    if st.n_window:
        if layer is None:
            raise ValueError("the window path needs the start layers")
        misses = torch.zeros(n, dtype=torch.int32, device=pos.device)
        clamp_misses = torch.zeros_like(misses)
    return Particles(pos=pos, depth=depth, cell=cell, alive=alive, pts=pts,
                     vels=torch.zeros_like(pts),
                     attrs=torch.zeros_like(pts) if st.pathline else None,
                     layer=layer if st.n_window else None, misses=misses,
                     clamp_misses=clamp_misses)


def _phases(st: Stepper, p: Particles, i: int):
    """Step ``i``'s first four PHASES for every particle of ``p`` as a
    generator: each resume runs the next phase (relocate, not on step 0;
    gather the cell's vertex ids; one fused step; the depth/radius update,
    which leaves the new state in ``p``) and yields.  The fourth yields the
    (buffer, value) pairs the record phase writes.  Launches work only:
    nothing here waits on the device, and past step 0 nothing depends on
    ``i`` but a pathline's alphas."""
    real = p.pos.dtype
    dt = st.dt
    pos, depth, cell, alive = p.pos, p.depth, p.cell, p.alive
    depth_neg = (-depth).to(real)
    if not st.is_first[i]:
        new_cell = _relocate_packed(st.mesh, st.reloc_xyz, pos, cell)
        cell = torch.where(alive, new_cell, cell)
    yield None
    vids, nv, vids_ok = _gather_cell_vertices(st.mesh, cell)
    s = None if p.layer is None \
        else window_starts(p.layer, st.n_layers, st.n_window)
    yield None
    out = st.step(pos, depth_neg, nv, vids, s, st.alphas[i])
    yield None
    if out.layer is not None:
        p.layer = torch.where(alive, out.layer, p.layer)
        counted = alive & vids_ok
        p.misses += (out.miss & counted).to(torch.int32)
        p.clamp_misses += (out.clamp & counted).to(torch.int32)
    # invalid vertex ids (reference R_VLA_FAIL) are checked outside the
    # step: zero the velocities and attributes and keep the position
    step_ok = out.ok & vids_ok
    hvel = _where0(vids_ok[:, None], out.hvel)
    wvel = _where0(vids_ok, out.wvel)
    new_pos = torch.where(vids_ok[:, None], out.new_pos, pos)

    write_ok = (alive & step_ok) if st.freeze else alive

    r = _norm(pos)
    new_depth = torch.clamp(depth.to(real) - wvel * dt, min=0.0)
    r_new = torch.clamp(r + wvel * dt, min=1.0)
    nlen = _norm(new_pos)
    new_pos = torch.where(
        (nlen > EPS_ZERO)[:, None],
        new_pos / torch.where(nlen == 0.0, torch.ones_like(nlen),
                              nlen)[:, None] * r_new[:, None],
        new_pos)

    p.pos = torch.where(write_ok[:, None], new_pos, pos)
    p.depth = torch.where(write_ok, new_depth.to(depth.dtype), depth)
    p.cell, p.alive = cell, write_ok
    records = [(p.vels, hvel)]
    if out.attr is not None:
        records.append((p.attrs, _where0(vids_ok[:, None], out.attr)))
    yield records


def record(st: Stepper, p: Particles, i: int, records) -> None:
    """Step ``i``'s record phase, after _phases: the first step's velocity
    (and attributes) into slot 0 (TBB kernel :988-991; the attribute
    buffer stays zero without attributes), and on a record step p.pos and
    each of ``records``' values into the step's slot, on the lanes that
    p.alive (the step's write mask) keeps."""
    upd = p.alive[:, None]
    if st.is_first[i]:
        for buf, val in records:
            buf[:, 0] = torch.where(upd, val, buf[:, 0])
    if st.flags[i]:
        s = int(st.slots[i])
        p.pts[:, s] = torch.where(upd, p.pos, p.pts[:, s])
        for buf, val in records:
            buf[:, s] = torch.where(upd, val, buf[:, s])
        if p.rec_ids is not None:
            p.rec_ids[:, s] = torch.where(p.alive, p.pid, p.rec_ids[:, s])


def advance(st: Stepper, p: Particles, i: int,
            ph: Optional[Phases] = None) -> None:
    """Step ``i`` of the run for every particle of ``p``, in place:
    relocate (not on step 0), gather the cell's vertex ids, one fused step,
    the depth/radius update and the records (PHASES; ``ph`` marks the end
    of each).  Launches work only: nothing here waits on the device."""
    for records in _phases(st, p, i):
        if ph is not None:
            ph.mark()
    record(st, p, i, records)
    if ph is not None:
        ph.mark()


# The Particles fields a step replaces with new tensors; a captured step
# copies each back into the tensor it began from.
_STATE = ("pos", "depth", "cell", "alive", "layer")
# Each CUDA device's capture stream, graph memory pool and anchor graph
# (_capture_place), made at its first capture and kept: every request
# captures on the one stream into the one pool, so that it reuses the
# memory its predecessor's graphs freed (a graph's own pool stays reserved
# after the graph is gone).  The step graphs are made and dropped within a
# request.  Captures take the lock: one capture at a time on the stream.
_CAPTURE: dict = {}
_CAPTURE_LOCK = threading.Lock()


def _capture_place(dev: torch.device):
    """(stream, pool) of ``dev``'s captures.  The pool keeps a one-node
    graph captured into it that is never replayed: torch's pinned host
    allocator counts a pool's users by its live graphs alone, and refuses a
    capture into a pool whose graphs are all gone."""
    if dev not in _CAPTURE:
        with torch.cuda.device(dev):
            stream, pool = torch.cuda.Stream(dev), torch.cuda.MemPool()
            anchor = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                anchor.capture_begin(pool=pool.id)
                torch.zeros(1, device=dev)
                anchor.capture_end()
        _CAPTURE[dev] = stream, pool, anchor
    return _CAPTURE[dev][:2]


# Steps a graphed loop runs eagerly before its capture: step 0 (the first
# step's slot-0 record, no relocation) and one plain step, whose launches
# load every kernel the capture takes and set the step kernels' attributes
# and resident_wave's answer.
GRAPH_WARM_STEPS = 2


class StepGraph:
    """A step of ``p`` past step 0 captured for replay: _phases as one CUDA
    graph, or with ``per_phase`` one graph a phase in one shared pool (so
    that detail marks each phase between replays: an event may not be
    recorded inside a capture).  Every replay reads and writes the same
    tensors: the capture ends by copying the step's new state (_STATE)
    back into the tensors ``p`` held, and ``records`` holds the values
    the record phase then writes, eagerly (its slot changes).  The kernel
    launches of the capture are tallied in ``launches``, not counted.

    On the CPU, which has no CUDA graphs, a replay runs the phases again:
    the graphed loop's logic, the same on both."""

    def __init__(self, st: Stepper, p: Particles, i: int, per_phase: bool):
        self.st, self.p, self.i = st, p, i
        self.static = {k: getattr(p, k) for k in _STATE}
        self.width = 1 if per_phase else len(PHASES) - 1
        self.records = None
        self._gen = None
        n = (len(PHASES) - 1) // self.width
        dev = p.pos.device
        if dev.type != "cuda":
            self.launches = {}
            self.replays = [functools.partial(self._run, j) for j in range(n)]
            return
        self.replays = []
        with _CAPTURE_LOCK, held_counts() as self.launches:
            stream, pool = _capture_place(dev)
            with torch.cuda.stream(stream):
                for j in range(n):
                    g = torch.cuda.CUDAGraph()
                    # thread_local: other threads' work may go on meanwhile
                    g.capture_begin(pool=pool.id,
                                    capture_error_mode="thread_local")
                    try:
                        self._run(j)
                    finally:
                        g.capture_end()
                    self.replays.append(g.replay)

    def _run(self, j: int) -> None:
        """Phases j*width .. (j+1)*width - 1 of step ``i``; after the last,
        the state copied back and the records kept."""
        if j == 0:
            self._gen = _phases(self.st, self.p, self.i)
        for _ in range(self.width):
            out = next(self._gen)
        if (j + 1) * self.width < len(PHASES) - 1:
            return
        for k, t in self.static.items():
            new = getattr(self.p, k)
            if new is not t:
                t.copy_(new)
                setattr(self.p, k, t)
        self.records = out

    def replay(self, ph: Optional[Phases] = None) -> None:
        """The captured phases once (``ph`` marks the end of each graph)."""
        for run in self.replays:
            run()
            if ph is not None:
                ph.mark()


def step_plan(is_first, flags) -> list:
    """Each step's kind in a graphed loop: "eager" (advance: the first
    GRAPH_WARM_STEPS steps and any first step), then "plain" (a StepGraph
    replay) or, where ``flags`` records, "record" (a replay, then the
    record phase at the schedule's slot)."""
    return ["eager" if i < GRAPH_WARM_STEPS or first
            else "record" if flag else "plain"
            for i, (first, flag) in enumerate(zip(is_first, flags))]


def run_graphed(st: Stepper, p: Particles,
                ph: Optional[Phases] = None) -> int:
    """Every step of ``p`` as step_plan orders: the eager steps through
    advance, the others by replays of one StepGraph captured at the first
    of them (per phase with ``ph``, which marks each phase) and dropped on
    return.  Counts each replay's kernel launches as the eager step would;
    returns the steps replayed."""
    graph, replayed = None, 0
    for i, kind in enumerate(step_plan(st.is_first, st.flags)):
        if kind == "eager":
            advance(st, p, i, ph)
            continue
        if graph is None:
            graph = StepGraph(st, p, i, ph is not None)
        graph.replay(ph)
        if kind == "record":
            record(st, p, i, graph.records)
        if ph is not None:
            ph.mark()
        replayed += 1
    if graph is not None:
        count_launches(graph.launches, replayed)
    return replayed


def resolve_graph(graph: Optional[bool], st: Stepper, devices) -> bool:
    """Whether run_advection's step loop replays captured steps
    (run_graphed): ``graph`` None turns it on for a kernel streamline run
    on one CUDA device; True asks for it where it applies (on the CPU a
    replay runs the step again), and raises on a pathline (its stage
    alphas reach the kernels by value, so a replay would repeat one
    step's), on several devices or on the plain path; False keeps the
    eager loop."""
    fits = st.kernel in ("k1", "k3") and len(devices) == 1
    if graph is None:
        return fits and devices[0].type == "cuda"
    if graph and not fits:
        raise ValueError("captured steps need a kernel streamline run on one "
                         "device")
    return bool(graph)


def resolve_window(use_kernel: bool, use_window: Optional[bool],
                   device: torch.device, n_layers: int) -> int:
    """The layer window's width for a run, 0 for the full-column step:
    ``use_window`` None turns the window on for a kernel run on a CUDA
    device with L > 2 (mops_tpu turns it on for compiled TPU runs); the
    width is min(L, max(4, WINDOW_LAYERS))."""
    windowed = use_kernel and (device.type == "cuda" and n_layers > 2
                               if use_window is None else bool(use_window))
    return min(n_layers, max(4, WINDOW_LAYERS)) if windowed else 0


def prepare(mesh: MPASMesh, front: SolutionFields,
            back: Optional[SolutionFields], settings: TrajectorySettings,
            real: torch.dtype, device, use_kernel: bool = True,
            exact_clamp: bool = True, use_window: Optional[bool] = None):
    """(Stepper, snapshots) of a run on ``device``: the mesh and the
    snapshots moved there in ``real`` (no-ops when they agree), their
    tables packed once, the window as resolve_window decides; snapshots is
    [front] or [front, back] on the device."""
    mesh_d = mesh.to(device, real)
    sols = [front.to(device, real)] + (
        [back.to(device, real)] if back is not None else [])
    st = make_stepper(mesh_d, *snapshot_tables(mesh_d, *sols), settings,
                      use_kernel, exact_clamp, resolve_window(
                          use_kernel, use_window, device,
                          front.vertex_ztop.shape[1]))
    return st, sols


def start_particles(st: Stepper, sols, seeds, cells, depths,
                    n_records: int) -> Particles:
    """new_particles on the stepper's device and dtype from host arrays,
    with the window path's first layers (seed_layers on the front)."""
    dev, real = st.table.device, st.table.dtype
    pos = torch.as_tensor(seeds, device=dev).to(real)
    cell = torch.as_tensor(cells, device=dev)
    depth = torch.as_tensor(depths, device=dev)
    layer = seed_layers(st.mesh, sols[0].vertex_ztop, pos, cell, depth) \
        if st.n_window else None
    return new_particles(st, pos, cell, depth, n_records, layer)


def resolve_path(st: Stepper) -> dict:
    """LAST_RESOLVED's record of a run through ``st``."""
    return {"kernel": st.kernel, "window": bool(st.n_window),
            "n_window": st.n_window, "pathline": st.pathline,
            "n_attrs": st.n_attrs,
            "dtype": str(st.table.dtype).removeprefix("torch."),
            "instance": column_instance(st.n_layers) if st.kernel
            else None}


def particle_bounds(n: int, n_slices: int) -> np.ndarray:
    """Start of each of ``n_slices`` contiguous slices of n particles (the
    first n % n_slices slices one longer), then n."""
    sizes = np.full(n_slices, n // n_slices)
    sizes[:n % n_slices] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def concat_raw(parts, device) -> RawTrajectories:
    """RawTrajectories of particle batches, concatenated in order on
    ``device`` (a single batch is only moved there)."""
    def cat(name):
        vals = [getattr(r, name) for r in parts]
        if vals[0] is None:
            return None
        if len(vals) == 1:
            return vals[0].to(device)
        return torch.cat([v.to(device) for v in vals])
    return RawTrajectories(**{f.name: cat(f.name)
                              for f in dataclasses.fields(RawTrajectories)})


def run_advection(mesh: MPASMesh, front: SolutionFields,
                  seeds, cells, settings: TrajectorySettings,
                  back: Optional[SolutionFields] = None,
                  exact_clamp: bool = True,
                  dtype: Optional[torch.dtype] = None,
                  use_kernel: bool = True,
                  device="cuda",
                  use_window: Optional[bool] = None,
                  chunk: Optional[int] = None,
                  devices=None, group=None,
                  graph: Optional[bool] = None) -> RawTrajectories:
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
    (fused_window_*_step) with windows of min(L, max(4, WINDOW_LAYERS))
    layers; None turns it on for a CUDA
    run with L > 2 (mops_tpu turns it on for compiled TPU runs), False
    keeps the full-column kernels.

    ``devices`` (default ``[device]``; entries may repeat) splits the
    particles into one contiguous slice a device: the tables are copied
    once to each distinct device, and every step launches each slice's
    work before anything waits on the host, so slices on distinct cards
    overlap (mops_tpu.parallel.run_advection_sharded).  ``chunk`` runs
    each device's slice in pieces of at most that many particles, one
    after another (mops_tpu.run_advection's chunk): it bounds the card
    memory of the (N, R, 3) record buffers of a large run.  Every particle
    sees the same operations on the same values either way, so the
    results equal the single whole run's; they are concatenated in
    particle order on the first device.

    ``group`` (a process group of parallel.distributed, every rank passing
    the same full-size ``seeds`` and ``cells``) first splits the particle
    axis over the ranks (``rank_bounds``): this rank runs its slice on its
    ``devices`` as above and returns its rows, which equal rows
    [start, stop) of the single-process run (``gather_trajectories`` puts
    the whole on one rank).

    ``graph`` replays each step past the first few from a captured CUDA
    graph (run_graphed, resolve_graph): None turns it on for a kernel
    streamline run on one CUDA device, False keeps the eager loop, which
    launches every step's work from Python.  The lines are the same
    either way, bit for bit.

    Every call records the path it took in LAST_RESOLVED.

    Spans (utils.timer): advect.prepare (the tables packed on each
    device) and advect.loop (the particles' start and the step loop, with
    the first device's stream time: GPUKernel).  With detail on (a
    profiler recording at the request's start) and one device, the loop
    also keeps PHASES, each a span of its host time and stream time summed
    over the steps, and counts advect.steps and, on the window path,
    advect.window_misses and advect.window_clamp_misses (the per-particle
    counts, summed when read).  Every call counts advect.graph_steps, the
    steps run by replay (0 on the eager loop).
    """
    devices = [resolve_device(d) for d in (devices or [device])]
    real = mesh.dtype if dtype is None else dtype
    n_steps, n_rec = settings.n_steps, settings.n_records
    if n_steps <= 0 or n_rec <= 0:
        raise ValueError("invalid integration steps "
                         f"(n_steps={n_steps}, n_records={n_rec})")
    if chunk is not None and int(chunk) < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    seeds = np.array(seeds)
    cells = np.array(cells, dtype=np.int32)
    depths = settings.effective_depths(len(seeds))
    if group is not None:
        from .parallel.distributed import rank_bounds
        a, b = rank_bounds(len(seeds), group)
        seeds, cells, depths = seeds[a:b], cells[a:b], depths[a:b]
    n = len(seeds)

    mgr = TimerManager.instance()
    detail = mgr.detail()
    # mesh + solution tables on each distinct device in the particle dtype
    with timer("advect.prepare", "Preprocessing"):
        steppers = {dev: prepare(mesh, front, back, settings, real, dev,
                                 use_kernel, exact_clamp, use_window)
                    for dev in dict.fromkeys(devices)}
    graphed = resolve_graph(graph, steppers[devices[0]][0], devices) \
        and n > 0
    LAST_RESOLVED.clear()
    LAST_RESOLVED.update(resolve_path(steppers[devices[0]][0]))

    def start(dev, a, b):
        st, sols = steppers[dev]
        return st, start_particles(st, sols, seeds[a:b], cells[a:b],
                                   depths[a:b], n_rec)

    # each device's slice in pieces of at most ``size``: round r runs every
    # device's r-th piece side by side
    bounds = particle_bounds(n, len(devices))
    size = max(1, n if chunk is None else int(chunk))
    pieces = [[(a, min(a + size, b)) for a in range(a0, b, size)]
              for a0, b in zip(bounds[:-1], bounds[1:])]
    if n == 0:
        pieces[0] = [(0, 0)]
    rounds = max(map(len, pieces))
    ph = Phases(PHASES, devices[0], (len(PHASES) * n_steps + 1) * rounds) \
        if detail and len(devices) == 1 else None
    step = advance if ph is None else functools.partial(advance, ph=ph)
    done = {}
    replayed = 0
    with timer("advect.loop", "GPUKernel", device=devices[0]):
        for r in range(rounds):
            batch = {(q, r): start(devices[q], *ps[r])
                     for q, ps in enumerate(pieces) if r < len(ps)}
            if ph is not None:
                ph.start()
            if graphed:
                replayed += run_graphed(*batch[0, r], ph)
            else:
                for i in range(n_steps):
                    for st, p in batch.values():
                        step(st, p, i)
            done.update({k: p.raw() for k, (_, p) in batch.items()})
        out = concat_raw([done[k] for k in sorted(done)], devices[0])
        if ph is not None:
            ph.close(mgr)
    mgr.add("advect.graph_steps", replayed)
    if detail:
        mgr.add("advect.steps", n_steps * rounds)
        for raw in done.values():
            if raw.window_misses is not None:
                mgr.add_lazy("advect.window_misses", raw.window_misses)
                mgr.add_lazy("advect.window_clamp_misses",
                             raw.window_clamp_misses)
    return out
