"""The port's headline benchmark: particle-RK4-steps/s of ``run_advection``
on one device (counterpart of the root bench.py).

    python -m mops_tpu_torch.bench                 # on the card
    python -m mops_tpu_torch.bench --device cpu    # on the CPU

Runs the full streamline RK4 advection loop (relocation, Wachspress
interpolation, vertical layer search, RK4 sphere update) on a synthetic
MPAS-like mesh in float32, on the path ``run_advection`` takes by default
(on the card the layer-window kernels K3 with their masked K1 repair),
after the gate below, and prints ONE JSON line:

    {"metric": "particle_rk4_steps_per_s", "value": N, "unit": "steps/s",
     "vs_baseline": 1.0, "verified": bool, "path": {...}}

``path`` is advect.LAST_RESOLVED of the timed run.  ``vs_baseline`` is
1.0: the root BENCH_BASELINE.json holds a value measured on a TPU v5e by the
JAX package, no baseline of this port or this card, so nothing is divided
by it.

Sizes come from bench.py's variables: BENCH_CELLS (20000), BENCH_LAYERS
(60), BENCH_PARTICLES (65536), BENCH_STEPS (200), BENCH_DT (120 s), and
BENCH_REGIME=crossing for the crossing regime (realistic vertical
velocities and bathymetry, so particles cross layers and the window path's
repair runs).

The gate (``gate``): before timing, the kernel path is held against the
plain path (``use_kernel=False``) on the same device over GATE_STEPS steps.
A lane passes when its final position is within max(100 m, 1e-4 x the
median displacement) of the plain path's; the gate passes when the medians
of the displacements agree within 5 % and at least GATE_SHARE of the lanes
pass (on a pathline with attributes, also that share of the passing lanes'
attribute records within 1e-4 of the largest attribute).  A broken path
moves nothing or everything; a lane may part legitimately where one
rounding flips a near-tie relocation, which the gate counts (tie flips,
TIE_GAP_M).

    python -m mops_tpu_torch.bench --trace         # off lanes classified

The exact clamp: bench.py runs mops_tpu's fast path with
``exact_clamp=False``; the port's kernels implement only the sequential
clamp (the reference's semantics), so here both paths run
``exact_clamp=True`` and the gate compares kernel and plain at the same
clamp.

stderr: the run's shape, elapsed seconds and window-miss rate; the gate's
shares and tie flips (``--trace``: every off lane classified, gate's
``trace``); a roofline line (on the card only): the step's least bytes
(advect.step_cost at the run's start inputs, counted after the timed run)
times steps a second against HBM_PEAK.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import advect, synth
from .cellsearch import CellSearch
from .config import EARTH_RADIUS
from .mesh import resolve_device
from .seeding import linear_depth_profile
from .settings import FailMode, TrajectorySettings
from .solution import preprocess

# Steps the gate runs.
GATE_STEPS = 20
# The roofline line's memory rate: one H100 SXM's HBM3 peak, 3.35 TB/s
# (NVIDIA's data sheet), bytes a second.
HBM_PEAK = 3.35e12
# The least share of lanes within tolerance, by run dtype.  float32: set
# from the share measured between the f32 kernel path and the f32 plain path
# on the card at 20k, 100k, 500k and 1M cells (PERF.md, the gate curve):
# the lowest was 99.928 % at 1M cells (47 of 65,536 lanes off), less a
# margin of 0.128 points, more than three times the spread (2.4 lanes) of
# the off count that rate gives on the 8,192 lanes bench_refscale gates.
# float64: bench.py's 99.5 % (measured 100 %, PERF.md).
GATE_SHARE = {torch.float32: 0.998, torch.float64: 0.995}
# Two paths part by a tie flip where they relocate a particle to different
# cells whose centres lie within this many metres of the same distance from
# it: 4 ulp of a float32 coordinate at Earth radius.
TIE_GAP_M = 2.0
# Two paths have parted a lane once their positions lie this far apart (the
# lane tolerance's floor) or their cells differ.
PART_M = 100.0
# Attribute records agree within this share of the largest attribute (a
# Wachspress sum in float32 loses ~1e3 epsilon).
ATTR_REL_TOL = 1e-4
# bench.py's crossing regime: realistic vertVelocityTop (1e-3 m/s, sign
# varying over the sphere), O(1) bathymetry gradients, no decay with depth,
# particles spread to 2,500 m.
CROSSING = dict(w_scale=1e-3, bathymetry_amp=0.5, shelf_lon=0.3,
                omega_decay=1.0)


def build_case(n_cells, n_layers, n_particles, seed=0, w_scale=1e-5,
               bathymetry_amp=0.0, shelf_lon=None, omega_decay=0.5,
               device="cuda"):
    """bench.py's case: a jittered Voronoi sphere of ``n_cells`` cells and
    ``n_layers`` layers, the solid-body field, ``n_particles`` uniform seeds
    from ``seed`` and their cells.  Returns (mesh and preprocessed fields on
    ``device`` in float32, float32 seeds, cells); the cell search runs on
    the float64 host mesh."""
    dev = resolve_device(device)
    mesh = synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=seed,
                                    n_layers=n_layers)
    raw = synth.solid_body_fields(mesh, n_layers=n_layers, w_scale=w_scale,
                                  omega_decay=omega_decay,
                                  bathymetry_amp=bathymetry_amp,
                                  shelf_lon=shelf_lon)
    mesh_d = mesh.to(dev, torch.float32)
    sol = preprocess(mesh_d, {k: np.asarray(v, dtype=np.float32)
                              for k, v in raw.items()}, dtype=torch.float32,
                     device=dev)
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_particles, 3))
    seeds = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * EARTH_RADIUS).astype(np.float32)
    cells = CellSearch(mesh).query(seeds)
    return mesh_d, sol, seeds, cells


def gate_check(kernel_pos, plain_pos, seeds, dtype,
               kernel_attrs=None, plain_attrs=None) -> dict:
    """The gate's criterion on final positions (and attribute records) of
    the kernel and plain paths from ``seeds``; ``dtype`` the run's, which
    sets the share (GATE_SHARE).  Returns verified, share, the lane
    tolerance, both median displacements, attr_share (None without
    attributes), the share required and the boolean lanes ``within``."""
    c = lambda a: (a.detach().cpu() if isinstance(a, torch.Tensor)
                   else torch.as_tensor(np.asarray(a))).double().numpy()
    fp, ep, s0 = c(kernel_pos), c(plain_pos), c(seeds)
    err = np.linalg.norm(fp - ep, axis=1)
    disp = float(np.median(np.linalg.norm(ep - s0, axis=1)))
    dispf = float(np.median(np.linalg.norm(fp - s0, axis=1)))
    tol = max(100.0, 1e-4 * max(disp, 1.0))
    within = err <= tol
    share = float(within.mean())
    need = GATE_SHARE[dtype]
    ok = share >= need and abs(dispf - disp) <= 0.05 * max(disp, 1.0)
    attr_share = None
    if kernel_attrs is not None:
        fa, ea = c(kernel_attrs), c(plain_attrs)
        a_tol = ATTR_REL_TOL * float(np.abs(ea).max())
        lane = np.abs(fa - ea).reshape(len(fa), -1).max(axis=1) <= a_tol
        attr_share = float(lane[within].mean()) if within.any() else 0.0
        ok = ok and attr_share >= need
    return {"verified": bool(ok), "share": share, "share_min": need,
            "tol_m": tol, "disp_plain_m": disp, "disp_kernel_m": dispf,
            "attr_share": attr_share, "off": int((~within).sum()),
            "within": within}


def gate(mesh, front, seeds, cells, settings: TrajectorySettings,
         back=None, dtype: torch.dtype = torch.float32, device="cuda",
         n_gate: Optional[int] = None,
         use_window: Optional[bool] = None, trace: bool = False) -> dict:
    """Hold the kernel path against the plain path on ``device`` in
    ``dtype``: the first ``n_gate`` particles (all by default) over the
    first GATE_STEPS steps of ``settings`` (simulation_duration and
    record_t cut to them, so a pathline's alphas sweep 0..1), the kernel
    path as run_advection takes it (``use_window``).  Both paths
    advance in lockstep (advect.advance, the step of every engine, so each
    equals its run_advection), which finds the first step where the two
    part each lane: they relocate it to different cells, or (in the same
    cell) their positions come PART_M apart.

    Returns gate_check's record without ``within``, plus ``lanes``,
    ``path`` (the kernel path's advect.resolve_path record) and
    ``tie_flips``: the off lanes whose first parting was a relocation to
    cells whose centres lie within TIE_GAP_M of the same distance from the
    particle (an off lane is at least PART_M from the plain path at the
    end, so it has parted).

    ``trace`` (a diagnostic; it reads every step's partings on the host)
    adds ``off_kinds``, the off lanes by how they first parted: "tie",
    another "relocation", "stall" (PART_M apart in the same cell because
    one path's step failed and left the particle where it was: its
    containment test at a cell edge or a guard flipped) or "same_cell"
    (PART_M apart in the same cell with both moving: a stage's containment
    or layer test flipped); ``pre_gap_max_m``, the largest distance between
    the two paths' positions at the start of an off lane's parting step;
    ``identical_start``, the off lanes whose parting step began from the
    same position in both paths (the step itself differed: a kernel
    disagreeing with its plain version, or the window step with the full
    one); and ``replay_agree``, the off lanes that parted in the same cell
    whose step, replayed on the plain path's state through the full-column
    kernel and its plain version (``replay``), agrees (on the card: the
    kernel matches the plain version on identical inputs, so the parting
    came from the states' rounding difference)."""
    dev = resolve_device(device)
    n = len(seeds) if n_gate is None else min(int(n_gate), len(seeds))
    depths = settings.effective_depths(len(seeds))[:n]
    seeds = np.asarray(seeds)[:n]
    cells = np.asarray(cells, dtype=np.int32)[:n]
    cfg = dataclasses.replace(
        settings, simulation_duration=settings.delta_t * GATE_STEPS,
        record_t=settings.delta_t * GATE_STEPS, particle_depths=depths)
    st_k, sols = advect.prepare(mesh, front, back, cfg, dtype, dev,
                                use_window=use_window)
    st_p = advect.make_stepper(st_k.mesh, st_k.table, st_k.table_b,
                               st_k.n_attrs, cfg, use_kernel=False)
    pk = advect.start_particles(st_k, sols, seeds, cells, depths,
                                cfg.n_records)
    pp = advect.start_particles(st_p, sols, seeds, cells, depths,
                                cfg.n_records)
    centres = st_k.mesh.cell_xyz.double()
    last = st_k.mesh.n_cells - 1
    parted = torch.zeros(n, dtype=torch.bool, device=dev)
    # the first parting relocated the lane apart, and then the two cells'
    # centre distances differed by ``gap``
    relocated = torch.zeros_like(parted)
    gap = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
    if trace:
        # the full-column kernel step (K1 or K2) that replay holds to st_p's
        st_f = advect.make_stepper(st_k.mesh, st_k.table, st_k.table_b,
                                   st_k.n_attrs, cfg)
        # 2: parted in the same cell, one path stalled; 3: both moved
        kind = torch.zeros(n, dtype=torch.int8, device=dev)
        pre_gap = torch.full_like(gap, float("nan"))
        agree = torch.zeros_like(parted)
    for i in range(cfg.n_steps):
        if trace:
            state = pp.pos.clone(), pp.depth.clone()
            before_k = pk.pos.double()
        before = pp.pos.double()
        advect.advance(st_k, pk, i)
        advect.advance(st_p, pp, i)
        cell_apart = pk.cell != pp.cell
        new = ~parted & (cell_apart | (
            (pk.pos.double() - pp.pos.double()).norm(dim=1) > PART_M))
        d_k = (before - centres[pk.cell.clamp(0, last).long()]).norm(dim=1)
        d_p = (before - centres[pp.cell.clamp(0, last).long()]).norm(dim=1)
        live = (pk.cell >= 0) & (pp.cell >= 0)
        gap = torch.where(new & cell_apart & live, (d_k - d_p).abs(), gap)
        relocated |= new & cell_apart
        parted |= new
        if trace:
            idx = torch.nonzero(new & ~cell_apart)[:, 0]
            if idx.numel():
                stalled = torch.minimum(
                    (pk.pos[idx].double() - before_k[idx]).norm(dim=1),
                    (pp.pos[idx].double() - before[idx]).norm(dim=1)) < 1.0
                kind[idx] = torch.where(stalled, 2, 3).to(torch.int8)
                agree[idx] = replay(st_f, st_p, state[0][idx],
                                    state[1][idx], pp.cell[idx], i)
            pre_gap = torch.where(new, (before - before_k).norm(dim=1),
                                  pre_gap)
    attrs = st_k.pathline and st_k.n_attrs > 0
    res = gate_check(pk.pos, pp.pos, seeds, dtype,
                     pk.attrs if attrs else None, pp.attrs if attrs else None)
    off = torch.as_tensor(~res.pop("within"), device=dev)
    tie = off & relocated & (gap < TIE_GAP_M)
    res.update(lanes=n, tie_flips=int(tie.sum()),
               path=advect.resolve_path(st_k))
    if trace:
        res.update(
            off_kinds={"tie": int(tie.sum()),
                       "relocation": int((off & relocated).sum()
                                         - tie.sum()),
                       "stall": int((off & (kind == 2)).sum()),
                       "same_cell": int((off & (kind == 3)).sum())},
            pre_gap_max_m=float(pre_gap[off].nan_to_num(0.0).max())
            if bool(off.any()) else 0.0,
            identical_start=int((off & (pre_gap == 0)).sum()),
            replay_agree=int((off & (kind >= 2) & agree).sum()))
    return res


def replay(kernel: advect.Stepper, plain: advect.Stepper, pos, depth, cell,
           i: int) -> torch.Tensor:
    """Whether step ``i`` of the full-column kernel stepper ``kernel`` (K1,
    or K2 at the step's alphas) and of its plain version ``plain`` agree on
    these particle states: ok equal and new positions within TIE_GAP_M
    (lanes (N,) bool)."""
    vids, nv, _ = advect._gather_cell_vertices(plain.mesh, cell)
    args = (pos.contiguous(), (-depth).to(pos.dtype).contiguous(), nv, vids,
            None, plain.alphas[i])
    got, want = kernel.step(*args), plain.step(*args)
    return (got.ok == want.ok) & ((got.new_pos.double()
                                   - want.new_pos.double()).norm(dim=1)
                                  <= TIE_GAP_M)


def gate_line(res: dict) -> str:
    """One stderr line of a gate's record."""
    attr = "" if res["attr_share"] is None \
        else f" attr_share={res['attr_share']:.5f}"
    kinds = res.get("off_kinds")
    if kinds is None:
        kinds = "" if res.get("tie_flips") is None \
            else f" (tie flips {res['tie_flips']})"
    else:
        kinds = " (" + " ".join(f"{k}={v}" for k, v in kinds.items()) + ")"
        kinds += (f" pre_gap_max={res['pre_gap_max_m']:.2f}m "
                  f"identical_start={res['identical_start']} "
                  f"replay_agree={res['replay_agree']}")
    return (f"# gate: lanes={res['lanes']} share={res['share']:.6f} "
            f"(min {res['share_min']}){attr} off={res['off']}{kinds} "
            f"tol={res['tol_m']:.1f}m disp_plain={res['disp_plain_m']:.1f}m "
            f"disp_kernel={res['disp_kernel_m']:.1f}m -> {res['verified']}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--trace", action="store_true",
                    help="classify the gate's off lanes (gate's trace)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_cells = int(os.environ.get("BENCH_CELLS", 20000))
    n_layers = int(os.environ.get("BENCH_LAYERS", 60))
    n_particles = int(os.environ.get("BENCH_PARTICLES", 65536))
    n_steps = int(os.environ.get("BENCH_STEPS", 200))
    delta_t = int(os.environ.get("BENCH_DT", 120))
    crossing = os.environ.get("BENCH_REGIME") == "crossing"
    real = torch.float32

    mesh, sol, seeds, cells = build_case(
        n_cells, n_layers, n_particles, device=dev,
        **(CROSSING if crossing else {}))
    depth_kw = dict(particle_depths=linear_depth_profile(
        n_particles, 10, 2500)) if crossing else dict(depth=100.0)
    cfg = TrajectorySettings(
        delta_t=delta_t, simulation_duration=delta_t * n_steps,
        record_t=delta_t * n_steps, fail_mode=FailMode.ZERO, **depth_kw)

    # Correctness gate BEFORE timing, on this device (never trust a
    # steps/s number without it: a kernel can be right on the CPU and
    # wrong on hardware).
    g = gate(mesh, sol, seeds, cells, cfg, dtype=real, device=dev,
             trace=args.trace)
    print(gate_line(g), file=sys.stderr)
    if not g["verified"]:
        print(f"# CORRECTNESS GATE FAILED: {100 * (1 - g['share']):.3f}% "
              f"lanes off (> {g['tol_m']:.1f} m); median displacement "
              f"kernel {g['disp_kernel_m']:.1f} vs plain "
              f"{g['disp_plain_m']:.1f} m", file=sys.stderr)

    def run():
        raw = advect.run_advection(mesh, sol, seeds, cells, cfg, dtype=real,
                                   device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return raw

    run()                                   # warm-up
    t0 = time.perf_counter()
    raw = run()
    elapsed = time.perf_counter() - t0
    path = dict(advect.LAST_RESOLVED)
    steps_per_s = n_particles * n_steps / elapsed
    misses = 0 if raw.window_misses is None \
        else int(raw.window_misses.sum())
    clamp = 0 if raw.window_clamp_misses is None \
        else int(raw.window_clamp_misses.sum())
    record = {"metric": "particle_rk4_steps_per_s",
              "value": round(steps_per_s, 1), "unit": "steps/s",
              "vs_baseline": 1.0, "verified": g["verified"], "path": path}
    print(json.dumps(record), flush=True)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={dev} ({name}) cells={n_cells} layers={n_layers} "
          f"particles={n_particles} steps={n_steps} elapsed={elapsed:.3f}s "
          f"regime={'crossing' if crossing else 'solid-body'} "
          f"window_misses={misses} (clamp {clamp}) "
          f"miss_rate={misses / (n_particles * n_steps):.2e}/particle-step",
          file=sys.stderr)
    if dev.type == "cuda":
        step_bytes, _ = advect.step_cost(
            mesh, [sol], seeds, cells, cfg.effective_depths(n_particles),
            path["n_attrs"], path["n_window"])
        traffic = step_bytes * n_steps / elapsed
        print(f"# roofline: kernel={path['kernel']} window={path['window']} "
              f"instance={path['instance']} step_bytes={step_bytes}B "
              f"traffic~{traffic / 1e9:.1f}GB/s "
              f"({100 * traffic / HBM_PEAK:.2f}% of the HBM peak "
              f"{HBM_PEAK / 1e12:.2f}TB/s)",
              file=sys.stderr)
    else:
        print("# roofline: not measured (no card)", file=sys.stderr)
    return {**record, "gate": g, "elapsed_s": elapsed,
            "window_misses": misses, "window_clamp_misses": clamp}


if __name__ == "__main__":
    main()
