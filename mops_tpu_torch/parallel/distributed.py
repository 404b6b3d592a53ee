"""The multi-process form: one process group over ranks on one host, the
counterpart of ``jax.distributed.initialize`` (scripts/dist_smoke.py).

Every rank runs the same program on the same full-size host arrays and
owns a part of the work: a contiguous slice of the particle axis
(``rank_bounds``, the sharded engine) or ``len(devices)`` of the
migrating engine's shards.  The only traffic is fixed-size blocks
(``exchange_blocks``) and the final gathers.

Transport, decided by the backend and never by catching an error:
NCCL moves the CUDA tensors themselves; gloo moves host tensors, so
gloo with CUDA tensors copies the blocks through pinned host buffers and
back (``staged``).  NCCL cannot put two ranks on one card, so
``init_distributed`` refuses that before any group is made.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..advect import RawTrajectories, particle_bounds
from ..mesh import resolve_device


def _rank_devices(rank: int, device, devices_per_rank: int) -> list:
    """Rank ``rank``'s devices by default: card ``rank % device_count()``
    repeated ``devices_per_rank`` times, or that many CPU devices."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [device] * int(devices_per_rank)
    card = torch.device("cuda", int(rank) % torch.cuda.device_count())
    return [card] * int(devices_per_rank)


def init_distributed(init_method: str, world_size: int, rank: int,
                     backend: Optional[str] = None,
                     devices_per_rank: int = 1, device="cuda",
                     devices: Optional[Sequence] = None):
    """Join the group of ``world_size`` ranks at ``init_method``
    (``tcp://localhost:<port>``) as ``rank``; returns (group, this rank's
    devices).

    ``devices`` (default: card rank % device_count(), or
    the CPU for device="cpu", ``devices_per_rank`` times; entries may
    repeat) are the rank's shard devices.  ``backend`` None means "nccl"
    for CUDA devices and "gloo" on the CPU.  The ranks share one host, so
    under NCCL more ranks than cards means two ranks on one card, which
    NCCL refuses: that raises here, before any group is made.  A CUDA
    request without a card raises (resolve_device); nothing falls back to
    the CPU or to another backend."""
    world_size, rank = int(world_size), int(rank)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    devices = [resolve_device(d) for d in devices] if devices is not None \
        else _rank_devices(rank, device, devices_per_rank)
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if not devices:
        raise ValueError("a rank needs at least one device")
    cuda = devices[0].type == "cuda"
    if any((d.type == "cuda") != cuda for d in devices):
        raise ValueError(f"a rank's devices mix the CPU and cards: {devices}")
    backend = backend or ("nccl" if cuda else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl":
        if not cuda:
            raise ValueError("NCCL needs CUDA devices; pass backend='gloo' "
                             "for a run on the CPU")
        cards = len({d.index for d in devices})
        have = torch.cuda.device_count()
        if world_size * cards > have:
            raise RuntimeError(
                f"NCCL cannot put two ranks on one card: {world_size} ranks "
                f"of {cards} card(s) each need {world_size * cards}, and this"
                f" machine has {have} ({torch.cuda.get_device_name(0)}); "
                "pass backend='gloo' to share a card")
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.group.WORLD, devices


def rank_bounds(n: int, group) -> tuple:
    """This rank's [start, stop) of an n-particle axis split into one
    contiguous slice a rank (advect.particle_bounds), the counterpart of
    ``addressable_shards[i].index``."""
    bounds = particle_bounds(int(n), dist.get_world_size(group))
    r = dist.get_rank(group)
    return int(bounds[r]), int(bounds[r + 1])


def staged(group, device) -> bool:
    """Whether collectives on ``device``'s tensors go through host buffers:
    gloo with CUDA tensors (gloo moves host memory)."""
    return torch.device(device).type == "cuda" \
        and dist.get_backend(group) == "gloo"


def transport(group, device) -> str:
    """The transport's name for logs: nccl, gloo, or gloo through pinned
    host buffers."""
    if staged(group, device):
        return "gloo through pinned host buffers"
    return dist.get_backend(group)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def exchange_blocks(send: torch.Tensor, group) -> torch.Tensor:
    """All-to-all of equal blocks: ``send`` (world, ...) holds block r for
    rank r; the result (world, ...) holds block r from rank r, on
    ``send``'s device.  One ``all_to_all_single`` with equal splits (the
    blocks are of fixed capacity, so the splits always are); under gloo
    CUDA blocks go through pinned host buffers (``staged``)."""
    world = dist.get_world_size(group)
    if send.shape[0] != world:
        raise ValueError(f"{send.shape[0]} send blocks for {world} ranks")
    send = send.contiguous()
    if staged(group, send.device):
        host = _to_host(send)
        recv = torch.empty_like(host)
        dist.all_to_all_single(recv, host, group=group)
        return recv.to(send.device, non_blocking=True)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def gather_blocks(t: torch.Tensor, group, dst: int = 0):
    """Every rank's ``t`` (the same shape on every rank) stacked in rank
    order on rank ``dst``, on ``t``'s device; None on the other ranks."""
    world, me = dist.get_world_size(group), dist.get_rank(group)
    t = t.contiguous()
    work = _to_host(t) if staged(group, t.device) else t
    bufs = [torch.empty_like(work) for _ in range(world)] if me == dst \
        else None
    dist.gather(work, bufs, dst=dst, group=group)
    if me != dst:
        return None
    return torch.stack(bufs).to(t.device)


def same_on_every_rank(value, group, what: str) -> None:
    """Raise on every rank when ranks passed different ``value``s."""
    values = [None] * dist.get_world_size(group)
    dist.all_gather_object(values, value, group=group)
    if len(set(values)) > 1:
        raise ValueError(f"{what} differs between ranks: {values}")


def gather_trajectories(raw: RawTrajectories, n: int, group, dst: int = 0):
    """The whole run's RawTrajectories in particle order on rank ``dst``
    (on ``raw``'s device), None on the other ranks: each rank's rows of
    ``run_advection(..., group=group)`` over n particles, padded to the
    largest slice for the collective, then trimmed."""
    bounds = particle_bounds(int(n), dist.get_world_size(group))
    sizes = np.diff(bounds)
    rows = int(sizes.max())
    if len(raw.points) != sizes[dist.get_rank(group)]:
        raise ValueError(f"{len(raw.points)} rows on rank "
                         f"{dist.get_rank(group)}, expected its slice of {n}")

    def whole(t):
        if t is None:
            return None
        pad = t.new_zeros((rows - len(t),) + tuple(t.shape[1:]))
        got = gather_blocks(torch.cat([t, pad]), group, dst)
        return None if got is None else torch.cat(
            [got[r, :s] for r, s in enumerate(sizes)])

    fields = {f.name: whole(getattr(raw, f.name))
              for f in dataclasses.fields(RawTrajectories)}
    return None if fields["points"] is None else RawTrajectories(**fields)
