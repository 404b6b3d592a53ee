"""Particle-axis data parallelism over a list of devices (mirror of
mops_tpu.parallel.sharding).

The mesh and solution tables are read-only gather tables, so each distinct
device holds one copy of them; the particles are split into contiguous
slices, one a shard, and every shard advances its slice with no
communication.  The engine is advect.run_advection's ``devices``: each
step launches every shard's work before anything waits on the host, so
shards on distinct cards overlap.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..advect import RawTrajectories, particle_bounds, run_advection
from ..mesh import MPASMesh, resolve_device
from ..settings import TrajectorySettings
from ..solution import SolutionFields


def device_list(n: int, device="cuda") -> list:
    """n shard devices: ``cuda:0`` .. ``cuda:n-1``, or n CPU shards for
    device="cpu".  Raises when the machine has fewer than n cards; it never
    runs on fewer devices than asked for."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [device] * int(n)
    have = torch.cuda.device_count()
    if int(n) > have:
        raise RuntimeError(f"{n} devices asked for, but this machine has "
                           f"{have} CUDA card(s)")
    return [torch.device("cuda", i) for i in range(int(n))]


def _devices(devices) -> list:
    """The shard devices of a run: ``devices`` (each checked), or every
    card of the machine."""
    if devices is None:
        return device_list(max(1, torch.cuda.device_count()))
    return [resolve_device(d) for d in devices]


def shard_particles(devices: Sequence, *arrays):
    """Split per-particle arrays along their first axis into one contiguous
    slice a device, each slice a tensor on its device: one list a given
    array."""
    devices = [torch.device(d) for d in devices]
    out = []
    for a in arrays:
        a = np.array(a)
        b = particle_bounds(len(a), len(devices))
        out.append([torch.as_tensor(a[b[p]:b[p + 1]], device=d)
                    for p, d in enumerate(devices)])
    return tuple(out)


def run_advection_sharded(mesh: MPASMesh, front: SolutionFields,
                          seeds, cells, settings: TrajectorySettings,
                          devices: Optional[Sequence] = None,
                          back: Optional[SolutionFields] = None,
                          dtype: Optional[torch.dtype] = None,
                          use_kernel: bool = True,
                          use_window: Optional[bool] = None,
                          group=None) -> RawTrajectories:
    """run_advection with the particle axis split over ``devices`` (default:
    every card of the machine; entries may repeat): one contiguous slice a
    device, its results equal to the single-device run's and concatenated
    in particle order on the first device.  With ``group`` the axis is
    first split over the ranks and this rank's rows come back.  The other
    arguments are run_advection's."""
    return run_advection(mesh, front, seeds, cells, settings, back=back,
                         dtype=dtype, use_kernel=use_kernel,
                         use_window=use_window, devices=_devices(devices),
                         group=group)
