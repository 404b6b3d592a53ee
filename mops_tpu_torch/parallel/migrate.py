"""Domain-decomposed advection with particle migration (mirror of
mops_tpu.parallel.migrate).

Each shard advances only the particles inside its mesh partition against
its local cell and vertex tables (decompose.py), through the same step as
the single-device run (advect.advance: K1/K2, or K3/K4 with their masked
repair, on the card).  Every ``migrate_every`` steps, particles whose cell
is owned by another shard leave: each shard ranks its leavers per
destination into fixed-capacity send blocks, block q of shard p goes to
shard q's device (the counterpart of ``jax.lax.all_to_all``), and each
shard places its arrivals into its pool's free slots.  Halo rings number
``migrate_every``, so relocation between exchanges never leaves a shard's
resident cells (a step moves a particle at most one ring).

With a process group (parallel.distributed) the shards are spread over
the ranks, each rank owning a contiguous range of them: the blocks bound
for each rank travel in one ``all_to_all_single`` a payload
(``exchange_blocks``), the counterpart of the JAX package's all_to_all
over a mesh that spans processes.

Capacity limits (send slots per destination, pool slots per shard) are
explicit; a particle lost to either is counted in ``dropped``, never lost
silently.  Records are tagged with particle ids and reassembled on id.
The exchange is cumsum and scatter arithmetic on each shard's device with
no host read, so a step's work on every shard is launched before anything
waits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..advect import (Particles, advance, make_stepper, pathline_attrs,
                      resolve_window, seed_layers)
from ..kernels.stage_kernel import pack_vertex_table
from ..mesh import MPASMesh
from ..settings import TrajectorySettings
from ..solution import SolutionFields
from .decompose import decompose
from .distributed import exchange_blocks, gather_blocks, same_on_every_rank
from .sharding import _devices

# Default send slots a destination: max(SEND_CAP_MIN, pool capacity // 4)
# (mops_tpu.parallel.migrate).
SEND_CAP_MIN = 64
# Int payload columns of a migrating particle, and the values an unused send
# slot holds: global cell, particle id (-1: no particle), carried layer,
# alive.
_INT_FILL = (-1, -1, 1, 0)


def _int_rows(n: int, device) -> torch.Tensor:
    """(n, 4) int32 rows of _INT_FILL, filled on the device (a tensor made
    from a Python list would be a host copy that waits on the stream)."""
    rows = torch.empty((n, len(_INT_FILL)), dtype=torch.int32, device=device)
    for col, v in enumerate(_INT_FILL):
        rows[:, col] = v
    return rows


@dataclasses.dataclass(frozen=True)
class MigratingTrajectories:
    """Per-shard-slot outputs stacked on the first device (a rank's own
    shards under a process group; gather_migrating stacks all of them);
    reassemble by particle id (see reassemble)."""

    rec_pos: torch.Tensor             # (P, cap, R, 3)
    rec_vel: torch.Tensor             # (P, cap, R, 3)
    rec_attr: Optional[torch.Tensor]  # (P, cap, R, 3), pathline only
    rec_ids: torch.Tensor             # (P, cap, R) int32 particle ids,
    #                                   -1: no record, -2 - id in slot 0:
    #                                   particle id's start record
    final_pos: torch.Tensor           # (P, cap, 3)
    final_depth: torch.Tensor         # (P, cap) float32
    final_ids: torch.Tensor           # (P, cap) int32, -1: empty slot
    dropped: torch.Tensor             # (P,) int32 particles lost to capacity
    window_misses: torch.Tensor       # (P,) int32 (particle, step) misses
    window_clamp_misses: torch.Tensor  # (P,) int32 of them the clamp test's
    migrated: torch.Tensor            # (P,) int32 particles sent by shard p


@dataclasses.dataclass
class _Shard:
    """One shard's id maps and counters on its device."""

    owner: torch.Tensor       # (nLC,) owning shard of each local cell
    cell_l2g: torch.Tensor    # (nLC,)
    cell_g2l: torch.Tensor    # (nCells,)
    dropped: torch.Tensor     # () int64
    sent: torch.Tensor        # () int64


def _local_mesh(dec, p: int, device, real) -> MPASMesh:
    """Shard p's local tables as an MPASMesh for the step (the tables the
    step does not read are empty)."""
    t = lambda a, dtype=None: torch.as_tensor(a[p], device=device,
                                              dtype=dtype)
    none2 = torch.full((0, 2), -1, dtype=torch.int32, device=device)
    voc = t(dec.vertices_on_cell)
    return MPASMesh(
        cell_xyz=t(dec.cell_xyz, real), vertex_xyz=t(dec.vertex_xyz, real),
        edge_xyz=torch.zeros((0, 3), dtype=real, device=device),
        n_edges_on_cell=t(dec.n_edges_on_cell), vertices_on_cell=voc,
        cells_on_cell=t(dec.cells_on_cell),
        cells_on_vertex=torch.full((dec.vertex_xyz.shape[1], 3), -1,
                                   dtype=torch.int32, device=device),
        edges_on_cell=torch.full_like(voc, -1), cells_on_edge=none2,
        vertices_on_edge=none2)


def _local_table(dec, p, device, real, suffix, n_attrs):
    """Shard p's packed vertex table of one snapshot ('' front, '_b' back)."""
    t = lambda name: torch.as_tensor(getattr(dec, name + suffix)[p],
                                     device=device, dtype=real)
    attrs = t("vertex_attrs") if n_attrs else None
    return pack_vertex_table(
        torch.as_tensor(dec.vertex_xyz[p], device=device, dtype=real),
        t("vertex_ztop"), t("vertex_velocity"), t("vertex_vert_velocity"),
        attrs)


def _leave(p: int, sh: _Shard, pt: Particles, n_shards: int,
           send_cap: int):
    """Shard p's send blocks: its leavers ranked per destination by a
    cumsum into ``send_cap`` slots each, overflow counted in ``dropped``,
    leaving slots vacated.  Returns the (P, send_cap, 4) float payload
    (pos, depth) and int payload (_INT_FILL's columns)."""
    dev = pt.pos.device
    occupied = pt.pid >= 0
    lcell = torch.clamp(pt.cell, min=0).long()
    dest = torch.where(occupied, sh.owner[lcell], -1)
    leave = occupied & (dest >= 0) & (dest != p)
    q = torch.arange(n_shards, device=dev)[:, None]
    dest_oh = (dest[None, :] == q) & leave[None, :]
    rank = torch.cumsum(dest_oh, dim=1) - 1
    oob = n_shards * send_cap
    send_to = torch.where(dest_oh & (rank < send_cap), q * send_cap + rank,
                          oob).amin(dim=0)
    sh.dropped += (leave & (send_to >= oob)).sum()
    sh.sent += leave.sum()
    # every particle that is not sent goes to a dump row of its own past
    # the blocks (no scatter drops an index, so none may collide)
    cap = pt.pid.shape[0]
    idx = torch.where(send_to < oob, send_to,
                      oob + torch.arange(cap, device=dev))
    layer = pt.layer if pt.layer is not None else torch.ones_like(pt.pid)
    fpay = torch.cat([pt.pos, pt.depth.to(pt.pos.dtype)[:, None]], dim=1)
    ipay = torch.stack([sh.cell_l2g[lcell], torch.where(leave, pt.pid, -1),
                        layer, pt.alive.to(torch.int32)], dim=1)
    fbuf = torch.zeros((oob + cap, 4), dtype=fpay.dtype, device=dev)
    ibuf = _int_rows(oob + cap, dev)
    fbuf.index_copy_(0, idx, fpay)
    ibuf.index_copy_(0, idx, ipay)
    pt.pid = torch.where(leave, -1, pt.pid)
    pt.alive = pt.alive & ~leave
    return (fbuf[:oob].view(n_shards, send_cap, 4),
            ibuf[:oob].view(n_shards, send_cap, 4))


def _arrive(sh: _Shard, pt: Particles, fpay, ipay) -> None:
    """Place arrivals (valid where their particle id >= 0) into the pool's
    free slots by rank; arrivals beyond the free slots are counted in
    ``dropped``."""
    dev = pt.pos.device
    cap, m = pt.pid.shape[0], ipay.shape[0]
    valid = ipay[:, 1] >= 0
    empty = pt.pid < 0
    slot = torch.arange(cap, device=dev)
    slots_by_rank = torch.full((2 * cap,), cap, dtype=torch.long,
                               device=dev)
    slots_by_rank.index_copy_(
        0, torch.where(empty, torch.cumsum(empty, 0) - 1, cap + slot), slot)
    rank = torch.cumsum(valid, 0) - 1
    can_place = valid & (rank < empty.sum())
    target = torch.where(can_place,
                         slots_by_rank[torch.clamp(rank, 0, cap - 1)],
                         cap + torch.arange(m, device=dev))
    sh.dropped += (valid & ~can_place).sum()
    ins_f = torch.zeros((cap + m, 4), dtype=fpay.dtype, device=dev)
    ins_i = _int_rows(cap + m, dev)
    ins_f = ins_f.index_copy_(0, target, fpay)[:cap]
    ins_i = ins_i.index_copy_(0, target, ipay)[:cap]
    placed = ins_i[:, 1] >= 0
    pt.pos = torch.where(placed[:, None], ins_f[:, :3], pt.pos)
    pt.depth = torch.where(placed, ins_f[:, 3].to(pt.depth.dtype), pt.depth)
    pt.cell = torch.where(
        placed, sh.cell_g2l[torch.clamp(ins_i[:, 0], min=0).long()],
        pt.cell)
    pt.pid = torch.where(placed, ins_i[:, 1], pt.pid)
    if pt.layer is not None:
        pt.layer = torch.where(placed, ins_i[:, 2], pt.layer)
    pt.alive = torch.where(placed, ins_i[:, 3] > 0, pt.alive)


def _across_ranks(sends, group):
    """Each local shard's arrivals from every shard of every rank, in
    global shard order: the local send stacks (P_local, P, send_cap, 4),
    reordered so that the blocks bound for each rank are contiguous, go in
    one all-to-all a payload."""
    n_local, world = len(sends), dist.get_world_size(group)
    d0 = sends[0][0].device
    out = []
    for k in (0, 1):                      # float payload, int payload
        stack = torch.stack([s[k].to(d0) for s in sends])
        cap = stack.shape[2]
        stack = stack.view(n_local, world, n_local, cap, 4).transpose(0, 1)
        recv = exchange_blocks(stack, group)   # (rank, src, dst, cap, 4)
        out.append([recv[:, :, q].reshape(-1, 4) for q in range(n_local)])
    return list(zip(*out))


def _exchange(shards, parts, send_cap: int, group=None) -> None:
    """One migration over every shard: send blocks, then block q of every
    shard p (in global p order) to shard q, then placement.  Without a
    group every shard is local and block q is copied to shard q's device;
    with one, this rank's shards are a contiguous range of the global
    shards and the blocks travel between ranks (_across_ranks)."""
    world = 1 if group is None else dist.get_world_size(group)
    first = 0 if group is None else dist.get_rank(group) * len(shards)
    n_shards = world * len(shards)
    sends = [_leave(first + p, sh, pt, n_shards, send_cap)
             for p, (sh, pt) in enumerate(zip(shards, parts))]
    if group is None:
        arrivals = [[torch.cat([s[k][q].to(pt.pos.device, non_blocking=True)
                                for s in sends]) for k in (0, 1)]
                    for q, pt in enumerate(parts)]
    else:
        arrivals = _across_ranks(sends, group)
    for sh, pt, (fpay, ipay) in zip(shards, parts, arrivals):
        dev = pt.pos.device
        _arrive(sh, pt, fpay.to(dev, non_blocking=True),
                ipay.to(dev, non_blocking=True))


def run_advection_migrating(mesh: MPASMesh, sol: SolutionFields,
                            seeds, cells, settings: TrajectorySettings,
                            devices: Optional[Sequence] = None,
                            capacity_factor: float = 2.0,
                            send_capacity: Optional[int] = None,
                            dtype: torch.dtype = torch.float32,
                            back: Optional[SolutionFields] = None,
                            migrate_every: int = 1,
                            use_kernel: bool = True,
                            use_window: Optional[bool] = None,
                            exact_clamp: bool = True, group=None
                            ) -> MigratingTrajectories:
    """Advection over a mesh decomposed into one longitude sector a device
    of ``devices`` (default: every card of the machine; entries may
    repeat), with particle migration every ``migrate_every`` steps.

    Each shard's pool holds ceil(N / P * ``capacity_factor``) slots, and
    each exchange sends at most ``send_capacity`` (default max(64,
    pool // 4)) particles from a shard to each other shard.  A particle
    starts on the shard that owns its start cell; a seed whose cell is -1
    (dead in run_advection) is in no pool and not counted as dropped.
    ``back`` switches to a pathline with up to two named attributes.  The
    window path's first layers come from a full-column search on the
    global tables, as in run_advection, and each particle carries its
    layer through the exchange.  The other arguments are run_advection's;
    each particle sees the single-device run's operations on the same
    values.

    ``group`` (parallel.distributed; every rank passing the same full-size
    inputs and as many ``devices``) spreads P = world x len(devices)
    shards over the ranks: rank r owns shards [r * len(devices),
    (r + 1) * len(devices)).  Every rank computes the same decomposition
    and initial distribution on the host and builds tables and pools for
    its own shards only; the result holds those shards (gather_migrating
    stacks all P on one rank).
    """
    devices = _devices(devices)
    first = 0
    n_shards = len(devices)
    if group is not None:
        same_on_every_rank(n_shards, group, "the number of local shards")
        first = dist.get_rank(group) * n_shards
        n_shards *= dist.get_world_size(group)
    k_mig = max(1, int(migrate_every))
    n_steps, n_rec = settings.n_steps, settings.n_records
    if n_steps <= 0 or n_rec <= 0:
        raise ValueError("invalid integration steps "
                         f"(n_steps={n_steps}, n_records={n_rec})")
    pathline = back is not None
    np_real = np.float32 if dtype == torch.float32 else np.float64

    af, ab, n_attrs = pathline_attrs(sol, back)
    dec = decompose(mesh, sol, n_shards, halo_rings=k_mig, dtype=np_real,
                    back=back, attrs_front=af, attrs_back=ab)
    n = len(seeds)
    cap = int(np.ceil(n / n_shards * capacity_factor))
    send_cap = send_capacity or max(SEND_CAP_MIN, cap // 4)
    n_window = resolve_window(use_kernel, use_window, devices[0],
                              sol.vertex_ztop.shape[1])

    # initial distribution: each particle to the owner of its start cell
    owner_g = np.full(mesh.n_cells, -1, dtype=np.int32)
    for p in range(n_shards):
        nl = dec.n_local_cells[p]
        own = dec.owner[p, :nl] == p
        owner_g[dec.cell_l2g[p, :nl][own]] = p
    cells = np.asarray(cells, dtype=np.int32)
    live = (cells >= 0) & (cells < mesh.n_cells)
    start_owner = np.where(live, owner_g[np.clip(cells, 0, None)], -1)
    seeds_t = torch.as_tensor(np.array(seeds), device=devices[0]).to(dtype)
    depths = torch.as_tensor(settings.effective_depths(n), device=devices[0])
    hints = None
    if n_window:
        hints = seed_layers(
            mesh.to(devices[0], dtype), sol.vertex_ztop.to(devices[0], dtype),
            seeds_t, torch.as_tensor(cells, device=devices[0]), depths)

    steppers, shards, parts = [], [], []
    for p, dev in enumerate(devices, start=first):
        table_b = _local_table(dec, p, dev, dtype, "_b", n_attrs) \
            if pathline else None
        st = make_stepper(_local_mesh(dec, p, dev, dtype),
                          _local_table(dec, p, dev, dtype, "", n_attrs),
                          table_b, n_attrs, settings, use_kernel,
                          exact_clamp, n_window)
        all_mine = np.nonzero(start_owner == p)[0]
        mine = torch.as_tensor(all_mine[:cap], device=devices[0])
        k = len(mine)
        local = lambda a, fill, dt: torch.cat([
            a.to(dev, dt), torch.full((cap - k,) + a.shape[1:], fill,
                                      dtype=dt, device=dev)])
        pos = local(seeds_t[mine], 0.0, dtype)
        alive = local(torch.ones(k, dtype=torch.bool), False, torch.bool)
        pid = local(mine, -1, torch.int32)
        pts = torch.zeros((cap, n_rec, 3), dtype=dtype, device=dev)
        pts[:, 0] = torch.where(alive[:, None], pos, pts[:, 0])
        rec_ids = torch.full((cap, n_rec), -1, dtype=torch.int32, device=dev)
        # slot 0 holds the start position (and step 0's velocity) until the
        # first record overwrites it, which may happen on another shard
        rec_ids[:, 0] = -2 - pid
        g2l = torch.as_tensor(dec.cell_g2l[p], device=dev)
        parts.append(Particles(
            pos=pos, depth=local(depths[mine], 0.0, torch.float32),
            cell=local(g2l[torch.as_tensor(cells[all_mine[:cap]],
                                           device=dev).long()], -1,
                       torch.int32),
            alive=alive, pts=pts, vels=torch.zeros_like(pts),
            attrs=torch.zeros_like(pts) if pathline else None,
            layer=local(hints[mine], 1, torch.int32) if n_window else None,
            misses=torch.zeros(cap, dtype=torch.int32, device=dev)
            if n_window else None,
            clamp_misses=torch.zeros(cap, dtype=torch.int32, device=dev)
            if n_window else None,
            pid=pid, rec_ids=rec_ids))
        shards.append(_Shard(
            owner=torch.as_tensor(dec.owner[p], device=dev),
            cell_l2g=torch.as_tensor(dec.cell_l2g[p], device=dev),
            cell_g2l=g2l,
            dropped=torch.tensor(len(all_mine) - k, device=dev),
            sent=torch.zeros((), dtype=torch.long, device=dev)))
        steppers.append(st)

    for i in range(n_steps):
        for st, pt in zip(steppers, parts):
            advance(st, pt, i)
        if (i + 1) % k_mig == 0 or i == n_steps - 1:
            _exchange(shards, parts, send_cap, group)

    d0 = devices[0]
    stack = lambda vals: torch.stack([v.to(d0) for v in vals])
    return MigratingTrajectories(
        rec_pos=stack(pt.pts for pt in parts),
        rec_vel=stack(pt.vels for pt in parts),
        rec_attr=stack(pt.attrs for pt in parts) if pathline else None,
        rec_ids=stack(pt.rec_ids for pt in parts),
        final_pos=stack(pt.pos for pt in parts),
        final_depth=stack(pt.depth for pt in parts),
        final_ids=stack(pt.pid for pt in parts),
        dropped=stack(sh.dropped for sh in shards).to(torch.int32),
        window_misses=stack(
            pt.misses.sum() if n_window else torch.zeros((), device=d0)
            for pt in parts).to(torch.int32),
        window_clamp_misses=stack(
            pt.clamp_misses.sum() if n_window else torch.zeros((), device=d0)
            for pt in parts).to(torch.int32),
        migrated=stack(sh.sent for sh in shards).to(torch.int32))


def gather_migrating(result: MigratingTrajectories, group, dst: int = 0):
    """Every rank's shards of ``run_advection_migrating(..., group=group)``
    stacked in global shard order on rank ``dst`` (on its result's
    device), None on the other ranks.  The pools have equal capacity on
    every rank, so every field has one shape."""
    def whole(t):
        if t is None:
            return None
        got = gather_blocks(t, group, dst)
        return None if got is None else got.flatten(0, 1)

    fields = {f.name: whole(getattr(result, f.name))
              for f in dataclasses.fields(MigratingTrajectories)}
    return None if fields["rec_pos"] is None \
        else MigratingTrajectories(**fields)


def reassemble(result: MigratingTrajectories, n_particles: int, seeds):
    """Trajectories by particle id, on the result's device: (points
    (N, R, 3) with slot 0 the seeds, velocities (N, R, 3), attrs (N, R, 3)
    or None, final_pos (N, 3), final_depth (N,)).  A particle's record in
    slot 0 replaces its start record, as in run_advection."""
    dev = result.rec_pos.device
    real = result.rec_pos.dtype
    n_rec = result.rec_pos.shape[2]
    ids = result.rec_ids.reshape(-1, n_rec).long()
    start = ids[:, 0] <= -2
    records = ids >= 0
    slot = torch.arange(n_rec, device=dev).expand_as(ids)[records]
    pid = ids[records]
    start_pid = -2 - ids[start, 0]

    def gather(rec, slot0=None):
        rec = rec.reshape(-1, n_rec, 3)
        out = torch.zeros((n_particles, n_rec, 3), dtype=real, device=dev)
        if slot0 is not None:
            out[:, 0] = slot0
        out[start_pid, 0] = rec[start, 0]
        out[pid, slot] = rec[records]
        return out

    points = gather(result.rec_pos, torch.as_tensor(
        np.array(seeds), device=dev).to(real))
    attrs = None if result.rec_attr is None else gather(result.rec_attr)
    fids = result.final_ids.reshape(-1).long()
    fok = fids >= 0
    final_pos = torch.zeros((n_particles, 3), dtype=real, device=dev)
    final_pos[fids[fok]] = result.final_pos.reshape(-1, 3)[fok]
    final_depth = torch.zeros(n_particles, dtype=result.final_depth.dtype,
                              device=dev)
    final_depth[fids[fok]] = result.final_depth.reshape(-1)[fok]
    return points, gather(result.rec_vel), attrs, final_pos, final_depth
