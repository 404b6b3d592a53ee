"""Trajectory finalization: record buffers -> TrajectoryLine list + NaN
cleanup (jax-free copy of mops_tpu.trajectory).

Host-side plumbing of reference src/Common/TrajectoryCommon.h:
  - InitTrajectoryLines (:43-55): each line starts with its seed point;
  - FinalizeTrajectoryLines[WithAttrs] (:131-190): append the R record slots;
    the reference pushes R velocities against R+1 points, and the WithAttrs
    variant copies velocity.x/.y into temperature/salinity (:179-180).
  - RemoveNaNTrajectoriesAndReindex (:57-129): truncate at the first
    non-finite point, pad with the last valid point, zero the velocity there.

``finalize_trajectories`` does all of it as block operations on the
records' own device (the card's records are finalized on the card), reads
each block back once, and gives every line row views of the host blocks.
``host_blocks`` makes those host blocks resident ahead of the read-back: the
API does so on a worker thread while the step loop runs, so that the copy
lands in pages that are already faulted in.
"""

from __future__ import annotations

import gc
import itertools
import warnings
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from .settings import TrajectoryLine, TrajectorySettings
from .utils.timer import TimerManager, timer, wait


def host_blocks(n: int, n_rec: int, pathline: bool) -> Dict[str, torch.Tensor]:
    """The float64 host blocks that finalize_trajectories reads ``n`` lines
    of ``n_rec`` records back into, each made resident: "pts" and "vel"
    (n, n_rec + 1, 3), and for a pathline "att" of that shape and "ts" (2,
    n, n_rec + 1).  A torch fill faults the pages in, spread over the
    intra-op threads with the GIL released (NumPy's fill holds the GIL)."""
    rows = (n, n_rec + 1, 3)
    shapes = {"pts": rows, "vel": rows}
    if pathline:
        shapes.update(att=rows, ts=(2, n, n_rec + 1))
    return {name: torch.empty(shape, dtype=torch.float64).zero_()
            for name, shape in shapes.items()}


def finalize_trajectories(seeds, points, velocities,
                          settings: TrajectorySettings,
                          attrs=None,
                          with_attrs: bool = False,
                          host: Optional[Future] = None
                          ) -> List[TrajectoryLine]:
    """Assemble + clean trajectory lines from raw (N, R, 3) record buffers
    (Common::FinalizeTrajectoryLines followed by
    RemoveNaNTrajectoriesAndReindex).

    The records may be NumPy arrays or torch tensors on any device; the
    float64 blocks are built and cleaned there (torch ops), then read back
    once (span advect.readback).  Each line's points, velocity,
    temperature, salinity and attrs are rows of those host blocks, its
    last_point a row of a block of its own.  With detail on, the counter
    trajectory.cut_lines counts the lines that held a non-finite point.

    ``host`` (internal) is a future of ``host_blocks``' dict for these
    records: the read-back waits for it (span trajectory.prefault_wait) and
    copies each block into its prepared block, which the lines then view.
    A block whose prepared one is missing or of another shape or dtype, or
    every block where the future raised, goes to new memory (``.cpu()``).
    Every call that copies (records off the CPU, or ``host`` given) counts
    trajectory.readback_blocks, the blocks read back, and
    trajectory.readback_ready, those copied into a prepared block.
    """
    points = torch.as_tensor(points)
    dev = points.device
    f64 = torch.float64
    n, n_rec = points.shape[:2]

    # points: [seed] + R records; velocity: R records + one trailing zero
    # (the cleanup's resize(original_len) append, TrajectoryCommon.h:88).
    pts = torch.empty((n, n_rec + 1, 3), dtype=f64, device=dev)
    pts[:, 0] = torch.as_tensor(seeds, dtype=f64, device=dev)
    pts[:, 1:] = points
    vel = torch.zeros((n, n_rec + 1, 3), dtype=f64, device=dev)
    vel[:, :-1] = torch.as_tensor(velocities, device=dev)
    att = ts = None
    if with_attrs and attrs is not None:
        att = torch.zeros((n, n_rec + 1, 3), dtype=f64, device=dev)
        att[:, :-1] = torch.as_tensor(attrs, device=dev)
        # reference bug preserved: temperature/salinity get velocity.x/.y
        # (TrajectoryCommon.h:179-180); ts[0] temperature, ts[1] salinity
        ts = torch.zeros((2, n, n_rec + 1), dtype=f64, device=dev)
        ts[:, :, :-1] = vel[:, :-1, :2].permute(2, 0, 1)

    # the first non-finite point of each line that has one; from there on
    # the line repeats its last finite point (the seed's where the seed
    # itself is not finite) and its velocity is zero from the point before
    bad = ~torch.isfinite(pts).all(dim=2)                        # (N, R+1)
    rows = bad.any(dim=1).nonzero().squeeze(1)
    if len(rows):
        j = torch.arange(n_rec + 1, device=dev)
        cut = torch.where(bad[rows], j, n_rec + 1).amin(dim=1,
                                                        keepdim=True)
        src = torch.where(j < cut, j, (cut - 1).clamp(min=0))    # (m, R+1)
        pts[rows] = pts[rows].gather(1, src[..., None].expand(-1, -1, 3))
        vel[rows] = vel[rows].masked_fill((j >= cut - 1)[..., None], 0.0)
        if ts is not None:
            ts[:, rows] = ts[:, rows].gather(2, src.expand(2, -1, -1))
    mgr = TimerManager.instance()
    if mgr.detail():
        mgr.add("trajectory.cut_lines", len(rows))

    blocks = {name: b for name, b in
              (("pts", pts), ("vel", vel), ("att", att), ("ts", ts))
              if b is not None}
    prepared = {}
    if host is not None:
        with timer("trajectory.prefault_wait", "Other"):
            prepared = _prepared(host)
    out, ready = {}, 0
    wait(dev)              # the read-back's span times the copies alone
    with timer("advect.readback", "MemoryCopy"):
        for name, block in blocks.items():
            dst = prepared.get(name)
            fits = dst is not None and dst.shape == block.shape \
                and dst.dtype == block.dtype
            out[name] = (dst.copy_(block) if fits else block.cpu()).numpy()
            ready += fits
    if dev.type != "cpu" or host is not None:
        mgr.add("trajectory.readback_blocks", len(blocks))
        mgr.add("trajectory.readback_ready", ready)
    pts, vel, att = out["pts"], out["vel"], out.get("att")
    # a streamline's temperature and salinity
    ts = out["ts"] if "ts" in out else np.zeros((2, n, n_rec + 1))
    return _lines(pts, vel, ts, att, settings)


def _prepared(host: Future) -> Dict[str, torch.Tensor]:
    """The prepared blocks of ``host``, once its worker is done; none where
    the worker raised (each block then goes to new memory)."""
    try:
        return host.result()
    except Exception as exc:        # whatever the worker raised
        warnings.warn(f"host blocks not prepared ({exc!r}): reading back "
                      "into new memory", RuntimeWarning)
        return {}


def _lines(pts, vel, ts, att, settings) -> List[TrajectoryLine]:
    """One TrajectoryLine a row of the host blocks (the cyclic collector
    paused while they are made: none of them holds a cycle)."""
    n = len(pts)
    last = pts[:, -1].copy()
    depths = settings.effective_depths(n).tolist()
    duration = itertools.repeat(float(settings.simulation_duration))
    timestamp = itertools.repeat(float(settings.delta_t))
    att = itertools.repeat(None) if att is None else att
    enabled = gc.isenabled()
    gc.disable()
    try:
        # TrajectoryLine's fields in order, one row of each block a line
        return list(itertools.starmap(TrajectoryLine, zip(
            range(n), pts, vel, ts[0], ts[1], last, duration, timestamp,
            depths, att)))
    finally:
        if enabled:
            gc.enable()


def remove_nan_trajectories_and_reindex(lines: List[TrajectoryLine]) -> List[TrajectoryLine]:
    """Standalone cleanup pass mirroring
    MPASOVisualizer::removeNaNTrajectoriesAndReindex
    (reference src/Core/MPASOVisualizer.cpp:304-307)."""
    cleaned: List[TrajectoryLine] = []
    for line in lines:
        p = np.asarray(line.points, dtype=np.float64).copy()
        if p.shape[0] == 0:
            continue
        n_pts = p.shape[0]
        v = np.zeros((n_pts, 3)) if line.velocity is None or len(line.velocity) == 0 \
            else np.asarray(line.velocity, dtype=np.float64).copy()
        if v.shape[0] < n_pts:
            v = np.concatenate([v, np.zeros((n_pts - v.shape[0], 3))], axis=0)
        t = np.resize(np.asarray(line.temperature, dtype=np.float64), n_pts) \
            if line.temperature is not None and len(line.temperature) else np.zeros(n_pts)
        s = np.resize(np.asarray(line.salinity, dtype=np.float64), n_pts) \
            if line.salinity is not None and len(line.salinity) else np.zeros(n_pts)

        finite = np.isfinite(p).all(axis=1)
        k = int((~finite).argmax()) if (~finite).any() else n_pts
        if k == 0:
            p[:] = p[0]
            v[:] = 0.0
            t[:] = t[0]
            s[:] = s[0]
        elif k < n_pts:
            p[k:] = p[k - 1]
            v[k - 1:] = 0.0
            t[k:] = t[k - 1]
            s[k:] = s[k - 1]
        cleaned.append(TrajectoryLine(
            line_id=len(cleaned),
            points=p, velocity=v, temperature=t, salinity=s,
            last_point=p[-1].copy(),
            duration=line.duration, timestamp=line.timestamp,
            depth=line.depth, attrs=line.attrs))
    return cleaned
