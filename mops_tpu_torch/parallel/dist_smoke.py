"""Multi-process smoke run of the port's engines over torch.distributed
(the counterpart of scripts/dist_smoke.py).

    python -m mops_tpu_torch.parallel.dist_smoke [--device cpu|cuda]
        [--backend gloo|nccl] [--world 2] [--per-rank 4] [--port P]
        [--out DIR] [--timeout S]

The launcher starts ``--world`` worker processes (``sys.executable -m
mops_tpu_torch.parallel.dist_smoke --worker i``: fresh interpreters, never
a fork of one that holds torch and its threads), each owning
``--per-rank`` shard devices.  Every worker builds the same 400-cell L4
mesh, 64 seeds and 10-step run as scripts/dist_smoke.py and checks:

- the particle-sharded engine across the group (64 seeds, and 63 so
  that the ranks' slices differ): its own rows equal rows [start, stop)
  of the single-process run it computes itself, and rank 0's gathered
  whole equals that run, bit for bit;
- the migrating engine over world x per-rank shards, run for
  MIGRATE_STEPS steps so that particles cross sectors: rank 0's gathered
  shards equal the in-process run over as many shards (counters too),
  and their reassembled records the single-process run, bit for bit,
  with every id once and none dropped;
- ranks passing different numbers of local shards raise on every rank
  (with more than one rank).

With ``--out`` rank 0 saves what it gathered (``dist_smoke_rank0.npz``).
It prints PASS or FAIL; the exit code is nonzero when a worker fails or
the run outlasts ``--timeout`` (its workers are killed), with no retry.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

from ..utils.subproc import free_port, run_workers

N_CELLS = 400
N_LAYERS = 4
N_SEEDS = 64
N_STEPS = 10
# 10 steps of the solid-body flow (~300 km) take no seed across a sector
# of 4; 60 take about a fifth of them
MIGRATE_STEPS = 60


def inputs(device):
    """scripts/dist_smoke.py's mesh, fields, seeds, cells and settings (the
    mesh and fields on ``device``, float64)."""
    import numpy as np

    import mops_tpu_torch as mtt
    mesh = mtt.synth.build_voronoi_mesh(N_CELLS, jitter=0.05, seed=0,
                                        n_layers=N_LAYERS)
    raw = mtt.synth.solid_body_fields(mesh, n_layers=N_LAYERS, w_scale=1e-4)
    sol = mtt.preprocess(mesh, raw, device=device)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(N_SEEDS, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mtt.EARTH_RADIUS
    cells = mtt.CellSearch(mesh).query(seeds)
    cfg = mtt.TrajectorySettings(delta_t=600,
                                 simulation_duration=600 * N_STEPS,
                                 record_t=1200, depth=100.0,
                                 fail_mode=mtt.FailMode.ZERO)
    return mesh.to(device), sol, seeds, cells, cfg


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _equal(a, b) -> bool:
    """Every field of two dataclasses of tensors equal (None alike)."""
    import torch
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y.to(x.device))):
            print(f"  field {f.name} differs", flush=True)
            return False
    return True


def worker(args) -> int:
    import numpy as np
    import torch

    from mops_tpu_torch.advect import run_advection
    from mops_tpu_torch.parallel import (gather_migrating,
                                         gather_trajectories,
                                         init_distributed, rank_bounds,
                                         reassemble, run_advection_migrating)
    from mops_tpu_torch.parallel.distributed import transport

    torch.set_num_threads(1)
    rank, world = args.worker, args.world
    group, devices = init_distributed(
        f"tcp://localhost:{args.port}", world, rank, backend=args.backend,
        devices_per_rank=args.per_rank, device=args.device)
    tag = f"[rank {rank}/{world}]"
    print(f"{tag} devices {[str(d) for d in devices]}, transport "
          f"{transport(group, devices[0])}", flush=True)
    mesh, sol, seeds, cells, cfg = inputs(devices[0])
    saved = {}

    for n in (N_SEEDS, N_SEEDS - 1):
        single = run_advection(mesh, sol, seeds[:n], cells[:n], cfg,
                               device=devices[0])
        mine = run_advection(mesh, sol, seeds[:n], cells[:n], cfg,
                             devices=devices, group=group)
        a, b = rank_bounds(n, group)
        rows = type(single)(**{
            f.name: None if getattr(single, f.name) is None
            else getattr(single, f.name)[a:b]
            for f in dataclasses.fields(single)})
        _check(_equal(mine, rows), f"sharded rows [{a}, {b}) of {n}")
        whole = gather_trajectories(mine, n, group)
        if rank == 0:
            _check(_equal(whole, single), f"gathered sharded run of {n}")
            for f in ("points", "velocities", "final_position",
                      "final_depth", "alive"):
                saved[f"sharded{n}_{f}"] = getattr(whole, f).cpu().numpy()
        print(f"{tag} sharded {n}: rows [{a}, {b}) equal the single run",
              flush=True)

    n_shards = world * args.per_rank
    kw = dict(capacity_factor=float(n_shards), dtype=mesh.dtype)
    cfg = dataclasses.replace(cfg, simulation_duration=600 * MIGRATE_STEPS)
    res = run_advection_migrating(mesh, sol, seeds, cells, cfg,
                                  devices=devices, group=group, **kw)
    whole = gather_migrating(res, group)
    if rank == 0:
        local = run_advection_migrating(
            mesh, sol, seeds, cells, cfg, devices=[devices[0]] * n_shards,
            **kw)
        _check(_equal(whole, local), "gathered migrating run")
        fids = whole.final_ids.cpu().numpy().ravel()
        ids = fids[fids >= 0]
        _check(len(ids) == N_SEEDS and len(np.unique(ids)) == N_SEEDS
               and int(whole.dropped.sum()) == 0
               and int(whole.migrated.sum()) > 0,
               "migration lost, duplicated or moved no particle")
        single = run_advection(mesh, sol, seeds, cells, cfg,
                               device=devices[0])
        points, vels, _, fpos, fdepth = reassemble(whole, N_SEEDS, seeds)
        _check(torch.equal(points, single.points)
               and torch.equal(vels, single.velocities)
               and torch.equal(fpos, single.final_position)
               and torch.equal(fdepth, single.final_depth),
               "reassembled migrating records")
        for f in dataclasses.fields(whole):
            val = getattr(whole, f.name)
            if val is not None:
                saved[f"migrating_{f.name}"] = val.cpu().numpy()
        print(f"{tag} migrating over {n_shards} shards: equal to the "
              f"in-process run; migrated {int(whole.migrated.sum())}",
              flush=True)

    if world > 1:
        try:
            run_advection_migrating(mesh, sol, seeds, cells, cfg,
                                    devices=[devices[0]] * (rank + 1),
                                    group=group, **kw)
        except ValueError as err:
            print(f"{tag} mismatched local counts raised: {err}", flush=True)
        else:
            raise AssertionError("mismatched local shard counts did not "
                                 "raise")

    if rank == 0 and args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, "dist_smoke_rank0.npz"), **saved)
    torch.distributed.destroy_process_group()
    print(f"{tag} ok", flush=True)
    return 0


def launch(args) -> int:
    """Start the workers, wait for all of them (stopping at the first
    failure, killing every one at the timeout), print their output and
    PASS or FAIL."""
    port = args.port or free_port()
    cmds = []
    for r in range(args.world):
        cmd = [sys.executable, "-m", "mops_tpu_torch.parallel.dist_smoke",
               "--worker", str(r), "--world", str(args.world),
               "--per-rank", str(args.per_rank), "--device", args.device,
               "--port", str(port)]
        if args.backend:
            cmd += ["--backend", args.backend]
        if args.out:
            cmd += ["--out", args.out]
        cmds.append(cmd)
    with tempfile.TemporaryDirectory() as logs:
        results, timed_out = run_workers(cmds, args.timeout, logs)
    for rc, out, err in results:
        print(out, end="", flush=True)
        print(err, end="", file=sys.stderr, flush=True)
    if timed_out:
        print(f"dist_smoke: timed out after {args.timeout} s", flush=True)
    rc = int(timed_out or any(rc != 0 for rc, _, _ in results))
    print("dist_smoke:", "PASS" if rc == 0 else "FAIL", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "mops_tpu_torch.parallel.dist_smoke")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--per-rank", type=int, default=4)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(args)
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
