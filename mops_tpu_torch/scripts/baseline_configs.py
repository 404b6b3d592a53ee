"""The five BASELINE.json measurement configs end to end on the port
(counterpart of scripts/baseline_configs.py), on synthetic MPAS-like
meshes:

  1. Streamline, 100 uniform seeds, single layer, coarse mesh, 1 day, dt=120 s
  2. Pathline, time-varying, 1k Gaussian seeds, Gulf of Mexico, 7 days
  3. Remap 1201x601 at fixed 20 m depth, full globe
  4. 1M-particle global pathline, multi-layer, 30 days (gather stress)
  5. Domain-decomposed migration run across 8 shards, all on the one
     device (the single-host stand-in of config 5)

    python -m mops_tpu_torch.scripts.baseline_configs [1 2 3 4 5] [--small]
    python -m mops_tpu_torch.scripts.baseline_configs 1 2 --small --device cpu

Each config prints one JSON line as the JAX script does (``config``,
``particles``, ``steps``, ``elapsed_s``, ``steps_per_s``, ``extra``;
config 3 ``pixels``, ``pixels_per_s``, ``finite_frac``) and returns it with
its final positions (images for config 3; config 5's migrating result).
Config 4 reads back only its final positions and finalizes no line.
float32 (each config function takes ``dtype``), with the exact
(sequential) clamp, the only one the kernels implement (the JAX script runs
``exact_clamp=False``).  Each timing is one run with nothing before it:
nothing compiles at run time, and the kernel library is built and loaded
before the first config (the JAX script times a second run after a
compiling one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import advect, remap, seeding, synth
from ..cellsearch import CellSearch
from ..config import EARTH_RADIUS
from ..field import Field
from ..kernels import stage_kernel as sk
from ..mesh import resolve_device
from ..parallel.migrate import run_advection_migrating
from ..settings import (ONE_DAY, ONE_HOUR, FailMode, SamplingSettings,
                        TrajectorySettings, VisualizationSettings)
from ..solution import preprocess

F32 = torch.float32


def make_case(n_cells, n_layers, device, dtype=F32, seed=0, **field_kw):
    """(host mesh, mesh and fields on ``device`` in ``dtype``) of a
    jittered Voronoi sphere with the solid-body field (w_scale 1e-5)."""
    mesh = synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=seed,
                                    n_layers=n_layers)
    mesh_d = mesh.to(device, dtype)
    return mesh, mesh_d, snapshot(mesh, mesh_d, n_layers, **field_kw)


def snapshot(mesh, mesh_d, n_layers, **field_kw):
    """The solid-body snapshot of ``mesh``, its raw fields rounded to
    float32 (as the JAX script's), preprocessed in ``mesh_d``'s dtype."""
    raw = synth.solid_body_fields(mesh, n_layers=n_layers, w_scale=1e-5,
                                  **field_kw)
    return preprocess(mesh_d, {k: np.asarray(v, np.float32)
                               for k, v in raw.items()}, dtype=mesh_d.dtype,
                      device=mesh_d.device)


def timed(dev, fn):
    """(fn(), seconds) with the device synchronised at both ends."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def report(name, n_particles, n_steps, elapsed, extra=""):
    rec = {"config": name, "particles": n_particles, "steps": n_steps,
           "elapsed_s": round(elapsed, 3),
           "steps_per_s": round(n_particles * n_steps / elapsed, 1),
           "extra": extra}
    print(json.dumps(rec), flush=True)
    return rec


def _uniform_seeds(n, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)
            * EARTH_RADIUS).astype(np.float32)


def config1(small, device="cuda", dtype=F32):
    """Streamline, 100 uniform seeds (11x11 box), 1 day, dt=120 s."""
    dev = resolve_device(device)
    mesh, mesh_d, sol = make_case(2000 if small else 20000, 10, dev, dtype)
    seeds = seeding.generate_sample_points(SamplingSettings(
        sample_range=(11, 11), lat_range=(20, 50), lon_range=(-80, -50),
        depth=10.0))
    cells = CellSearch(mesh).query(seeds)
    cfg = TrajectorySettings(delta_t=120, simulation_duration=ONE_DAY,
                             record_t=120, depth=10.0,
                             fail_mode=FailMode.ZERO)
    raw, dt = timed(dev, lambda: advect.run_advection(
        mesh_d, sol, seeds.astype(np.float32), cells, cfg, dtype=dtype,
        device=dev))
    return report("1-streamline-100", len(seeds), cfg.n_steps, dt), \
        raw.final_position


def config2(small, device="cuda", dtype=F32):
    """Pathline, 1k Gaussian seeds, Gulf of Mexico, 7 days."""
    dev = resolve_device(device)
    mesh, mesh_d, sol = make_case(2000 if small else 20000, 20, dev, dtype)
    sol2 = snapshot(mesh, mesh_d, 20, omega=1.2e-5)
    seeds = seeding.generate_gaussian_points(
        SamplingSettings(lat_range=(18.0, 31.0), lon_range=(-98.0, -80.0)),
        1000, mean_lat=25.0, mean_lon=-90.0, std_dev=3.0, seed=7)
    cells = CellSearch(mesh).query(seeds)
    cfg = TrajectorySettings(delta_t=600, simulation_duration=7 * ONE_DAY,
                             record_t=6 * ONE_HOUR, depth=50.0,
                             fail_mode=FailMode.ZERO)
    raw, dt = timed(dev, lambda: advect.run_advection(
        mesh_d, sol, seeds.astype(np.float32), cells, cfg, back=sol2,
        dtype=dtype, device=dev))
    return report("2-pathline-gaussian-1k", len(seeds), cfg.n_steps, dt), \
        raw.final_position


def config3(small, device="cuda", dtype=F32):
    """Remap 1201x601 at fixed 20 m depth, full globe (the host pixel
    query is cached by the Field, so a first call warms it)."""
    dev = resolve_device(device)
    mesh, mesh_d, sol = make_case(2000 if small else 20000, 20, dev, dtype)
    field = Field(mesh, sol, device=dev, dtype=dtype)
    w, h = (301, 151) if small else (1201, 601)
    cfg = VisualizationSettings(image_width=w, image_height=h,
                                fixed_depth=20.0)
    remap.run_remapping(field, cfg)          # the host pixel query, cached
    imgs, elapsed = timed(dev, lambda: remap.run_remapping(field, cfg))
    finite = float(np.isfinite(imgs[0][..., 2]).mean())
    rec = {"config": "3-remap", "pixels": w * h,
           "elapsed_s": round(elapsed, 3),
           "pixels_per_s": round(w * h / elapsed, 1),
           "finite_frac": round(finite, 4)}
    print(json.dumps(rec), flush=True)
    return rec, imgs


def config4(small, device="cuda", dtype=F32):
    """1M-particle global pathline, multi-layer, 30 days at 1 h steps, in
    pieces of 131,072 particles (bounding the record buffers)."""
    dev = resolve_device(device)
    n_part = 100_000 if small else 1_000_000
    n_steps = 200 if small else 720
    mesh, mesh_d, sol = make_case(5000 if small else 20000, 40, dev, dtype)
    sol2 = snapshot(mesh, mesh_d, 40, omega=1.2e-5)
    seeds = _uniform_seeds(n_part)
    cells = CellSearch(mesh).query(seeds)
    cfg = TrajectorySettings(
        delta_t=3600, simulation_duration=3600 * n_steps,
        record_t=3600 * n_steps,
        particle_depths=seeding.linear_depth_profile(n_part, 10, 500),
        fail_mode=FailMode.ZERO)
    raw, dt = timed(dev, lambda: advect.run_advection(
        mesh_d, sol, seeds, cells, cfg, back=sol2, dtype=dtype, device=dev,
        chunk=131072))
    return report("4-pathline-1M", n_part, cfg.n_steps, dt), \
        raw.final_position


def config5(small, device="cuda", dtype=F32):
    """Domain-decomposed migration run: 8 shards on the one device,
    migrate_every 8."""
    dev = resolve_device(device)
    n_part = 20_000 if small else 200_000
    mesh, mesh_d, sol = make_case(2000 if small else 20000, 20, dev, dtype)
    seeds = _uniform_seeds(n_part)
    cells = CellSearch(mesh).query(seeds)
    cfg = TrajectorySettings(delta_t=3600, simulation_duration=3600 * 100,
                             record_t=3600 * 25, depth=50.0,
                             fail_mode=FailMode.ZERO)
    res, dt = timed(dev, lambda: run_advection_migrating(
        mesh_d, sol, seeds, cells, cfg, devices=[dev] * 8, dtype=dtype,
        migrate_every=8))
    dropped = int(res.dropped.sum())
    return report("5-migration", n_part, cfg.n_steps, dt,
                  extra=f"shards={res.final_ids.shape[0]} "
                        f"dropped={dropped}"), res


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", type=int, default=[1, 2, 3, 4, 5])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={dev} ({name})", file=sys.stderr)
    if dev.type == "cuda":
        sk._library()                  # built and loaded before any timing
    return [CONFIGS[c](args.small, dev)[0]
            for c in (args.configs or [1, 2, 3, 4, 5])]


if __name__ == "__main__":
    main()
