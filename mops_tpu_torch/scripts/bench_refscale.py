"""Reference-scale cases of the port on one card (counterpart of
scripts/bench_refscale.py), each gated before it is timed:

  A. 500k cells x L80 streamline (eddy-resolving scale: the reference's
     oRRS18to6-class meshes have 80 levels)
  B. 2M cells x L40 streamline (oRRS18to6-class cell count)
  D. config-4 spec: 1M cells x L40, 10M particles, pathline, chunk=131072
  E. config-5 spec: 1M cells x L60, 10M particles on the migrating engine,
     8 shards on the one card (as chip_smoke.py phase 6e places them)

    python -m mops_tpu_torch.scripts.bench_refscale [A B D E] [--out FILE]
    python -m mops_tpu_torch.scripts.bench_refscale A --device cpu

Case C is not ported: it sweeps MOPS_PACK_BUDGET_GB and
MOPS_WINDOW_BUDGET_GB, the budgets of mops_tpu's packed and strided window
tables, TPU layouts that the port does not have (its window kernels read
the packed vertex table directly).  Case B keeps the JAX script's L40,
chosen there for one TPU v5e's memory; on the card 2M x L80 fits as well.

Each case prints one JSON line on stdout (steps/s, ``verified`` from
bench.gate on the first ``n_gate`` lanes, window misses, peak device
memory, the path of advect.LAST_RESOLVED with the step's least bytes, the
timed run's kernel launches (stage_kernel.launch_counts))
and the host set-up seconds on stderr.  ``--out`` also writes them to a
JSON file; nothing is written to the root BENCH_REFSCALE.json, which is a
record of the JAX package on a TPU.

As in bench.py's port (mops_tpu_torch.bench), every run uses the exact
(sequential) clamp, the only one the kernels implement, where the JAX
script runs ``exact_clamp=False``.  The timed run is one run with nothing
before it: nothing compiles at run time, and the kernel library is built
and loaded before the first case.  The case functions take their sizes as
arguments, with the JAX script's as defaults, so that they run small.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import advect, bench, synth
from ..cellsearch import CellSearch
from ..config import EARTH_RADIUS
from ..kernels import stage_kernel as sk
from ..mesh import MPASMesh, resolve_device
from ..parallel.migrate import reassemble, run_advection_migrating
from ..seeding import linear_depth_profile
from ..settings import FailMode, TrajectorySettings
from ..solution import preprocess

@dataclasses.dataclass
class Case:
    """A built case: the host mesh (float64), the mesh and its fields by
    dtype on the device, float32 seeds and their cells, and the set-up
    seconds."""

    mesh: MPASMesh
    meshes: dict
    sols: dict
    seeds: np.ndarray
    cells: np.ndarray
    seconds: dict


def build(n_cells, n_layers, n_particles, seed=0, with_attrs=False,
          crossing=False, device="cuda", dtypes=(torch.float32,)) -> Case:
    """The JAX script's ``build``: a jittered Voronoi sphere, the
    solid-body field (bench.CROSSING's with ``crossing``), temperature and
    salinity only ``with_attrs``, preprocessed on ``device`` in each of
    ``dtypes`` from float32 raw fields (slimmed without attributes), uniform
    seeds and their cells."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    mesh = synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=seed,
                                    n_layers=n_layers)
    t1 = time.perf_counter()
    raw = synth.solid_body_fields(mesh, n_layers=n_layers,
                                  **(bench.CROSSING if crossing
                                     else {"w_scale": 1e-5}))
    if not with_attrs:
        raw = {k: v for k, v in raw.items()
               if k not in ("temperature", "salinity")}
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    meshes, sols = {}, {}
    for real in dtypes:
        meshes[real] = mesh.to(dev, real)
        sol = preprocess(meshes[real], raw, dtype=real, device=dev)
        sols[real] = sol if with_attrs else sol.slim()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_particles, 3))
    seeds = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * EARTH_RADIUS).astype(np.float32)
    cells = CellSearch(mesh).query(seeds)
    t3 = time.perf_counter()
    seconds = {"mesh": t1 - t0, "preprocess": t2 - t1, "seed_query": t3 - t2}
    print(f"# built cells={n_cells} L={n_layers} N={n_particles}: mesh "
          f"{seconds['mesh']:.1f}s preprocess {seconds['preprocess']:.1f}s "
          f"seed-query {seconds['seed_query']:.1f}s", file=sys.stderr,
          flush=True)
    return Case(mesh, meshes, sols, seeds, cells, seconds)


def _timed(dev, fn):
    """(fn(), seconds, peak device memory in GB or None, launches)."""
    before = sk.launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None
    after = sk.launch_counts()
    return out, seconds, peak, {k: after[k] - before[k] for k in after}


def _record(name, case, n_layers, n_steps, seconds, peak, launches, g,
            dev, **extra):
    n = len(case.seeds)
    return {"case": name, "cells": case.mesh.n_cells, "layers": n_layers,
            "particles": n, "steps": n_steps,
            "steps_per_s": round(n * n_steps / seconds, 1),
            "elapsed_s": round(seconds, 3), "verified": g["verified"],
            "gate": {k: g[k] for k in ("lanes", "share", "share_min", "off",
                                       "tie_flips", "attr_share")},
            "peak_gb": peak, "launches": launches,
            "setup_s": case.seconds,
            "device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu", **extra}


def path_record(mesh, sols, case: Case, settings) -> dict:
    """advect.LAST_RESOLVED of the last run plus ``step_bytes``, the step's
    least bytes at the case's start inputs (advect.step_cost: a pass over
    every particle, so it is counted after the timed run)."""
    path = dict(advect.LAST_RESOLVED)
    path["step_bytes"], _ = advect.step_cost(
        mesh, sols, case.seeds, case.cells,
        settings.effective_depths(len(case.seeds)), path["n_attrs"],
        path["n_window"])
    return path


def window_misses(raw) -> dict:
    """A run's window misses (particle-steps; 0 without a window) and
    those of them that only the clamp test flagged (the rest are edge
    misses)."""
    count = lambda t: 0 if t is None else int(t.sum())
    return {"window_misses": count(raw.window_misses),
            "window_clamp_misses": count(raw.window_clamp_misses)}


def log(rec):
    print(json.dumps(rec), flush=True)


def streamline_settings(n_steps: int) -> TrajectorySettings:
    """The streamline cases' run: dt 120 s, ``n_steps`` steps, one record
    at the end, all particles at 100 m, FailMode.ZERO."""
    return TrajectorySettings(delta_t=120, simulation_duration=120 * n_steps,
                              record_t=120 * n_steps, depth=100.0,
                              fail_mode=FailMode.ZERO)


def streamline_case(name, case: Case, n_steps=100, device="cuda",
                    dtype=torch.float32, use_window=None, n_gate=8192):
    """The JAX script's streamline case on a built ``case``
    (streamline_settings), gated, then one timed run
    (the window path by default, ``use_window=False`` the full column).
    Returns (record, the run's RawTrajectories)."""
    dev = resolve_device(device)
    mesh, sol = case.meshes[dtype], case.sols[dtype]
    cfg = streamline_settings(n_steps)
    g = bench.gate(mesh, sol, case.seeds, case.cells, cfg, dtype=dtype,
                   device=dev, n_gate=n_gate, use_window=use_window)
    print(bench.gate_line(g), file=sys.stderr, flush=True)
    raw, seconds, peak, launches = _timed(dev, lambda: advect.run_advection(
        mesh, sol, case.seeds, case.cells, cfg, dtype=dtype, device=dev,
        use_window=use_window))
    rec = _record(name, case, sol.vertex_ztop.shape[1], n_steps, seconds,
                  peak, launches, g, dev, **window_misses(raw),
                  path=path_record(mesh, [sol], case, cfg))
    return rec, raw


def case_A(n_cells=500_000, n_layers=80, n_particles=65_536, n_steps=100,
           case: Optional[Case] = None, **kw):
    """500k cells x L80, streamline (``case`` a prebuilt one)."""
    case = case or build(n_cells, n_layers, n_particles,
                         device=kw.get("device", "cuda"),
                         dtypes=(kw.get("dtype", torch.float32),))
    return streamline_case("refscale-500k", case, n_steps, **kw)


def case_B(n_cells=2_000_000, n_layers=40, n_particles=65_536, n_steps=100,
           case: Optional[Case] = None, **kw):
    """2M cells x L40, streamline."""
    case = case or build(n_cells, n_layers, n_particles,
                         device=kw.get("device", "cuda"),
                         dtypes=(kw.get("dtype", torch.float32),))
    return streamline_case("refscale-2M", case, n_steps, **kw)


def case_D(n_cells=1_000_000, n_layers=40, n_particles=10_000_000,
           n_steps=100, chunk=131_072, n_gate=8192, device="cuda",
           dtype=torch.float32):
    """Config-4 spec: a pathline between two snapshots (the back one at
    omega 1.2e-5), depths 10..500 m, dt 3600 s, in pieces of ``chunk``
    particles.  Returns (record, the final positions)."""
    dev = resolve_device(device)
    case = build(n_cells, n_layers, n_particles, device=dev, dtypes=(dtype,))
    raw2 = synth.solid_body_fields(case.mesh, n_layers=n_layers, omega=1.2e-5,
                                   w_scale=1e-5)
    mesh, front = case.meshes[dtype], case.sols[dtype]
    back = preprocess(mesh, {k: np.asarray(v, np.float32)
                             for k, v in raw2.items()
                             if k not in ("temperature", "salinity")},
                      dtype=dtype, device=dev).slim()
    cfg = TrajectorySettings(
        delta_t=3600, simulation_duration=3600 * n_steps,
        record_t=3600 * n_steps,
        particle_depths=linear_depth_profile(n_particles, 10, 500),
        fail_mode=FailMode.ZERO)
    g = bench.gate(mesh, front, case.seeds, case.cells, cfg, back=back,
                   dtype=dtype, device=dev, n_gate=n_gate)
    print(bench.gate_line(g), file=sys.stderr, flush=True)
    raw, seconds, peak, launches = _timed(dev, lambda: advect.run_advection(
        mesh, front, case.seeds, case.cells, cfg, back=back, dtype=dtype,
        device=dev, chunk=chunk))
    rec = _record("config4-spec", case, n_layers, n_steps, seconds, peak,
                  launches, g, dev, chunk=chunk, **window_misses(raw),
                  path=path_record(mesh, [front, back], case, cfg))
    return rec, raw.final_position


def migrating_gate(case: Case, sol, cfg, shards, dtype, n_gate,
                   migrate_every):
    """bench.gate_check on the migrating engine: the kernel path against
    the plain path on the first ``n_gate`` particles over GATE_STEPS steps,
    final positions by particle id (reassemble), tie flips not traced."""
    n = min(n_gate, len(case.seeds))
    gcfg = dataclasses.replace(
        cfg, simulation_duration=cfg.delta_t * bench.GATE_STEPS,
        record_t=cfg.delta_t * bench.GATE_STEPS)
    finals = []
    for use_kernel in (True, False):
        res = run_advection_migrating(
            case.meshes[dtype], sol, case.seeds[:n], case.cells[:n], gcfg,
            devices=shards, dtype=dtype, migrate_every=migrate_every,
            use_kernel=use_kernel)
        finals.append(reassemble(res, n, case.seeds[:n])[3])
    g = bench.gate_check(finals[0], finals[1], case.seeds[:n], dtype)
    g.pop("within")
    g.update(lanes=n, tie_flips=None)
    return g


def case_E(n_cells=1_000_000, n_layers=60, n_particles=10_000_000,
           n_steps=100, n_shards=8, capacity_factor=1.25, migrate_every=8,
           n_gate=8192, device="cuda", dtype=torch.float32):
    """Config-5 spec on the migrating engine: ``n_shards`` longitude
    sectors all on the one device, dt 3600 s, 50 m, migrate_every 8.
    Returns (record, the MigratingTrajectories)."""
    dev = resolve_device(device)
    case = build(n_cells, n_layers, n_particles, device=dev, dtypes=(dtype,))
    sol = case.sols[dtype]
    cfg = TrajectorySettings(delta_t=3600, simulation_duration=3600 * n_steps,
                             record_t=3600 * 25, depth=50.0,
                             fail_mode=FailMode.ZERO)
    shards = [dev] * n_shards
    g = migrating_gate(case, sol, cfg, shards, dtype, n_gate, migrate_every)
    print(bench.gate_line(g), file=sys.stderr, flush=True)
    out, seconds, peak, launches = _timed(dev, lambda: run_advection_migrating(
        case.meshes[dtype], sol, case.seeds, case.cells, cfg, devices=shards,
        capacity_factor=capacity_factor, dtype=dtype,
        migrate_every=migrate_every))
    fids = out.final_ids.cpu().numpy()
    occ = (fids >= 0).sum(axis=1) / fids.shape[1]
    rec = _record("config5-spec", case, n_layers, n_steps, seconds, peak,
                  launches, g, dev, shards=n_shards,
                  dropped=int(out.dropped.sum()),
                  window_misses=int(out.window_misses.sum()),
                  window_clamp_misses=int(out.window_clamp_misses.sum()),
                  migrated=int(out.migrated.sum()),
                  occupancy=[float(occ.min()), float(np.median(occ)),
                             float(occ.max())])
    return rec, out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", default=["A", "B", "D", "E"])
    ap.add_argument("--out", default=None,
                    help="also write the results to this JSON file")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    which = set(args.cases or ["A", "B", "D", "E"])
    if not which <= {"A", "B", "D", "E"}:
        ap.error(f"unknown cases {sorted(which - {'A', 'B', 'D', 'E'})} "
                 "(case C is not ported)")
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={dev} ({name})", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        sk._library()                  # built and loaded before any timing
    results = []
    for key, fn in (("A", case_A), ("B", case_B), ("D", case_D),
                    ("E", case_E)):
        if key in which:
            rec, out = fn(device=dev)
            del out
            log(rec)
            results.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": name, "results": results}, f, indent=1)
        print(f"# wrote {args.out}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
