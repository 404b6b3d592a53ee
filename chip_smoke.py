#!/usr/bin/env python3
"""Smoke run of mops_tpu_torch on one CUDA card: build, check, run, gate.

    python3 chip_smoke.py
    python3 chip_smoke.py --window-ab DIR   # K3/K4 against another checkout

Phases (any failure exits non-zero; the last line is printed only on
success):

0. set-up: card name and power limit, the timed nvcc build of the kernels
   (mops_tpu_torch/csrc/stage_kernel.cu and row_gather.cu ->
   mops_tpu_torch/_build/, both started together), and ptxas's registers
   and spills of every kernel.
1. kernel checks at the slice's shape (K = the mesh's maxEdges, L = 60, all
   particles; K1's and K2's shared memory a particle and particles a block
   at that shape), each kernel against its plain PyTorch version on the same
   inputs, float32 and float64, RK4 and Euler, with out-of-cell,
   below-bottom, above-surface and dead lanes; per-step times of both:
   K1 (streamline); K2 (pathline: two snapshots, 0 and 2 attributes, stage
   alphas mid-run and near 1, where the clip engages); K3 and K4 (their
   layer-window forms, W = 8, windows placed around each lane's layer and
   moved off it on some lanes so that they miss; each call is the window
   kernel and K1's (K2's) masked repair of the miss lanes; every step
   kernel is timed in its Euler form too, to part a stage's cost from the
   rest).
1b. the window kernels on rising columns (RISING_CASE, the bench's
   crossing-regime case whose field has a vertex column rising above the
   surface, at L60 and L80: K1/K2's L <= 64 and generic repair instances):
   K3 and K4 at f32 and f64, RK4 and Euler, against their plain versions
   and against K1 (K2) bit for bit on every lane, the flagged ones among
   them; the lanes the clamp test flags and on how many of them the
   window step alone (its arithmetic without the clamp test) parts from
   the full step; the traced gate of the window path on the L60 case at
   f32 and f64, which must find no lane parted from identical states.
1c. the row-gather probe K5: its main path, ``python -m
   mops_tpu_torch.prof_dma`` at prof_dma.py's shape, driven with the counts
   set to 0 just before it; then the kernel against its plain version and
   beside torch.index_select at three shapes: (a) prof_dma.py's, (b) the
   streamline slice's packed table with the valid vertex slots of the
   seeds' cells as ids, (c) the same on the pathline front table.
2. the main paths, each driven with every launch count set to 0 just
   before it and read just after: synth -> preprocess (on the card) ->
   CellSearch -> run_advection -> finalize_trajectories at the slice size,
   a jittered Voronoi sphere of 236,853 cells (EC30to60E2r2's count) with
   60 layers and 400x400 global seeds at depths 10..500 m, float32:
   2a. streamline, the default (layer-window) path, K3 and one masked K1
       repair launch a step: the crossing-regime solid-body field, dt
       120 s for one day, a record every 360 s;
   2b. the same through the full-column kernel (use_window=False), K1;
   2a and 2b replay each step past advect.GRAPH_WARM_STEPS from a captured
   CUDA graph (run_advection's default on one card), whose launch counters
   are added a replay at a time: each is run again under torch.profiler
   (kernel_census), where the step kernels the trace shows, the counters
   and the steps replayed must each be one a step (census_faults) and the
   lines bit-equal to the timed run's;
   2c. pathline, the default path, K4 and its K2 repair: the reference's
       pathline tutorial
       (tutorial/pathLine.cpp), two snapshots at ocean speeds (solid-body
       rotation at 3e-7 and 3.6e-7 rad/s, about 1.9 and 2.3 m/s at the
       equator) with temperature and salinity, RK4, dt 600 s for one month
       (4,320 steps), a record every 6 h;
   2d. the same through the full-column kernel, K2, and the two pathline
       runs held against each other.
   On 2a and 2c: the edge and clamp misses' shares of particle-steps, and
   an untimed run again with the clamp probe (ClampProbe): the lane-steps
   only the clamp test flagged and on how many of them the window step
   alone would have parted from the full step, its final positions
   bit-equal to the timed run's; the probe's run takes the eager loop,
   so 2a's probe also holds the graphed run to the eager one.
3. gate: the first 20 steps through both kernel paths against the plain
   torch path on the card, streamline and pathline, float32 and float64,
   by the bench's criterion (mops_tpu_torch.bench.gate_check: its share a
   dtype, set from the share measured against mesh size).
4. profile: torch.profiler over a 30-step run of each kernel path, in
   float32 and float64: the device's busy time, its idle share and the
   time per device kernel (PERF.md, "Where the time goes"); on the window
   paths the masked K1 (K2) repair launches' device time apart from K3's
   (K4's), beside the edge and clamp misses' shares.
5. the user's front door on the card, on the slice's mesh:
   5a. remap: run_remapping at 3601x1801 (the reference demo,
       CLI/main.cpp:137, at the CLI's default 10 m) and 1201x601 (BASELINE
       config 3, 20 m), float32 and float64, with the pathline front's two
       attributes; the host KD query's seconds apart from the device's,
       pixels per second; gates: the float64 image against the port's remap
       core on CPU tensors over every 16th row of 1201x601 (NaN masks equal,
       values within 1e-9 of the image's largest magnitude) and each float32
       image against its float64 image (the demo size also under
       torch.profiler: busy time, idle share, time per device kernel) (NaN masks and values within 1e-4 of
       the largest magnitude on >= 99.9 % of pixels); run_fixed_layer at
       layer 10 (1201x601) and run_regrid at latitude 20 deg (3601x60) at
       float64 with the same row gate;
   5b. the API: MOPS_Init("cuda", "fp32"), phase 2's own fields, then
       MOPS_RunStreamLine over the day and MOPS_RunPathLine over the month,
       whose last points must equal phase 2a's and 2c's bit for bit (same
       dtype, kernels and inputs), with the launch counts checked, the
       streamline run again under torch.profiler as 2a's (kernel_census),
       and the timing summary printed;
   5c. the CLI in-process (--synthetic 20000 --layers 60 --remap-size
       1201x601 --samples 31x31, a day at dt 120 s) into a temporary
       directory: the raw-dict add_solution path on the card; every output
       file present and the VTP holding n_lines x (n_records + 1) points.

6. the multi-device engines (mops_tpu_torch.parallel), every shard on
   the one card, each sub-phase driven with the launch counts set to 0
   just before it and read just after:
   6a. run_advection_sharded, 4 shards, the streamline day through the
       window path: positions and records bit-equal to phase 2a's, 4x its
       K3 and repair launches; MOPS_Init with more devices than cards
       raises;
   6b. run_advection_migrating, 8 shards, the day at migrate_every 1 and 8
       through the window path and at 8 through K1: particles migrate, none
       is dropped or duplicated, the reassembled points, velocities, final
       positions and depths bit-equal to phase 2a's (2b's for K1; the
       share of final positions within 100 m printed), pool occupancy; the
       exchange's share of a step under torch.profiler over 30 steps;
   6c. the pathline month migrating (8 shards, migrate_every 8, K4 and its
       K2 repair): its trajectories and attribute records bit-equal to
       phase 2c's, attribute records non-zero;
   6d. send_capacity=1 on 64 seeds just west of a sector boundary: every
       lost particle counted, the survivors' final positions those of the
       single-device run;
   6e. BASELINE config 5 at its own shape (scripts/baseline_configs.py:
       158-186): 20,000 cells, L20, 200,000 seeds, 100 steps of 3600 s,
       migrate_every 8, 8 shards: particle-RK4-steps/s and dropped.

7. across processes (mops_tpu_torch.parallel.distributed), the agent and
   the frontend, on the one card; workers are ``python3 chip_smoke.py
   --phase7-worker ...`` processes that load phase 2's mesh, fields, seeds
   and 2a's results from a temporary directory and the kernel library from
   _build (neither is rebuilt), each killed at a timeout that fails the
   phase:
   7a. 2 ranks over gloo, both on the card, the streamline day through the
       window path (run_advection(group=)): each rank's rows bit-equal to
       2a's rows [start, stop), the whole gathered on rank 0 bit-equal to
       2a, each rank's K3 and repair launches counted, and its slice run
       again under torch.profiler as 2a's (kernel_census); wall time, each
       rank's step loop, particle-RK4-steps/s;
   7b. the same 2 ranks, 2 x 4 migrating shards at migrate_every 8: rank
       0's reassembled records bit-equal to 2a, every id once, none
       dropped; the all_to_all_single calls counted and timed (gloo
       through pinned host buffers: nothing of NCCL);
   7c. NCCL at world size 1 in this process, 8 shards at migrate_every 8:
       every exchange an all_to_all_single over NCCL, the gathered result
       bit-equal to 6b's migrate_every-8 run in every field; NCCL asked for
       with two ranks on the card raises (init_distributed), and two raw
       torch.distributed NCCL ranks on the card fail (NCCL's message
       printed);
   7d. NetCDF-3 files of a 20,000-cell L60 mesh and two snapshots, the
       port's server in a thread: GET /api/status names cuda and the card;
       POST /api/task runs a one-day streamline, a pathline and a
       1201x601 remap job on the card (each success, its seconds and its
       job process's launches printed); the streamline VTP holds n_lines x
       (n_records + 1) points and the remap PNGs exist.
   Phase 5a also requires the native host cell search (CellSearch.backend
   "native") and times it once beside cKDTree at 3601x1801.

8. the reference's vertical resolution, 80 layers (REFSCALE:
   scripts/bench_refscale.py case A's 500,000 cells and 65,536 seeds, in
   the crossing regime), where K1 and K2 launch their generic (L > 64)
   instances, then the port's remaining entries:
   8a. phase 1's kernel checks at L80 (K1-K4 against their plain versions,
       f32 and f64, RK4 and Euler, phase 1's lanes; K2/K4 with 0 and 2
       attributes at mid-run alphas), each kernel's time a launch beside
       its plain version's and its bound, K1's and K2's shared memory a
       particle and particles a block, ptxas's registers and spills of
       every generic instance (the plain f32 ones must not spill: phase 1);
   8b. case A through mops_tpu_torch.scripts.bench_refscale: 100 steps at
       dt 120 s and 100 m on the window path (100 K3 launches and 100
       generic K1 repairs) and the full column (100 generic K1 launches),
       each gated (bench.gate) on 8,192 lanes at f32 and f64 with
       LAST_RESOLVED's instance "generic"; steps/s, window misses, peak
       device memory, the two paths' final positions within 100 m on at
       least bench.GATE_SHARE of the lanes; the repair's device time a step
       under torch.profiler; the edge and clamp misses' shares; the clamp
       probe's run (eager), its final positions bit-equal to the timed
       (graphed) run's;
   8e. (run after 8b, once 8a's and 8b's fields are freed) the pathline
       tutorial's month at L80 on case A's mesh (pathline_month): two
       snapshots at ocean speeds (phase 2c's omegas and field) with
       temperature and salinity, preprocessed on the card at f32 and f64,
       the 400x400 global grid at 10..500 m, RK4 at dt 600 s for 4,320
       steps, a record every 6 h, f32; first K2's generic instance and K4
       one step against their plain versions on check_lanes of these
       160,000 seeds (f32 and f64, RK4 and Euler, 2 attributes, alphas
       mid-month and near 1), the device memory logged above what was
       allocated before 8e; then the window path (4,320 K4 launches
       and 4,320 repairs by the generic masked K2, no other kernel) and the
       full column (4,320 generic K2 launches), each timed with the counts
       set to 0 just before it, LAST_RESOLVED's instance "generic" with 2
       attributes; particle-RK4-steps/s, the edge and clamp misses'
       shares, peak device memory, finalize_trajectories' seconds; the
       clamp probe's rerun bit-equal to the timed run; the two paths'
       final positions within 100 m on at least bench.GATE_SHARE of the
       lanes, attribute records non-zero on ATTR_NONZERO of the alive
       lanes, output shapes as phase 2's; bench.gate on 8,192 lanes spread
       over the grid at f32 and f64 through both paths, attributes
       included; the repair's device time a step under torch.profiler;
   8c. mops_tpu_torch.scripts.baseline_configs 1-4 at full size (config 5
       is 6e), each JSON line printed, the outputs finite (config 4: 1M
       particles x 720 pathline steps, its final positions read back, no
       line finalized);
   8d. the four tutorials (mops_tpu_torch.tutorials) at their defaults in
       a temporary directory: every file written, the streamline VTP
       holding n_lines x (n_records + 1) points; each one's seconds.

The line before the card's name lists each kernel with its launches on
its main path, its time and its plain version's time at the slice shape,
its bound: the larger of the bytes the step must move (each input read
once, each output written once, counted from this run's start inputs) over
the card's memory rate and the operations it does over the card's peak
rate, the time of the one PyTorch call that computes the same function
where there is one, and ptxas's registers and spills.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# Float32 tolerances of the kernel check.  The ulp of a float32 coordinate at
# Earth radius is 0.5 m; a step rounds the position a few times at that
# scale (pos + hv*dt, normalise, times r), so new positions may differ by a
# few ulp: 4 ulp = 2 m.  Velocities are Wachspress sums whose weights come
# from triangle areas of 6.4e6-m coordinates differing by ~5e4 m: the
# cancellation costs ~1e3 x float32 epsilon, so hvel and wvel are held to
# 1e-4 of their largest magnitude.  A lane on a cell edge or a layer
# interface may flip its containment/guard test under one rounding
# difference: at most 1e-4 of the lanes may disagree on ok (or, for the
# window kernels, on the layer or the miss flag), and those lanes are left
# out of the value comparison.  ok is the AND of four stages, so a stage
# that flips while another fails on both sides leaves ok equal but the
# averaged velocity different: such lanes beyond tolerance count against
# the same budget, and even they must stay within the output's largest
# magnitude (for positions: the largest step, max |hvel| * |dt|).
F32_POS_TOL = 2.0
F32_REL_TOL = 1e-4
F32_OK_FLIPS = 1e-4
# Float64 tolerances: tests/test_pallas.py's (positions 1e-6 m, hvel
# 1e-10 m/s, wvel 1e-12 m/s, ok equal).
F64_TOL = (1e-6, 1e-10, 1e-12)
# Attributes are Wachspress sums like the velocities: 1e-4 of their largest
# magnitude at float32, and test_advect.py's pathline attribute tolerance
# (1e-8) at float64.
F64_ATTR_TOL = 1e-8

# The card's peak rates for the bound (NVIDIA H100 SXM data sheet, at the
# 700 W limit): HBM3 bytes/s and FP32/FP64 operations/s outside the tensor
# cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12}

# The slice's mesh, fields and seeds are mops_tpu_torch.prof_dma's
# (SLICE_CELLS, ...).  The streamline runs one day at dt 120 s; the
# pathline tutorial's run (tutorial/pathLine.cpp) dt 10 min for one month,
# a record every 6 h.
N_STEPS = 720
PROFILE_STEPS = 30
PATH_DT = 600
PATH_STEPS = 4320
PATH_RECORD = 6 * 3600
# Layers per window of the window kernels (run_advection's default) and
# lanes of the kernel check whose window is moved off their layer.
WINDOW = 8
# Phase 1b's rising-column case: the bench's crossing-regime case
# (mops_tpu_torch.bench.build_case) of RISING_CASE cells and seeds at depths
# 10..2,500 m, whose field has a vertex column rising above the surface, at
# RISING_LAYERS (the L <= 64 and the generic repair instances).
RISING_CASE = (3000, 2048)
RISING_LAYERS = (60, 80)
# Tolerance of the row-gather probe's float64 block sums against the plain
# version's, relative to the sum of the block's magnitudes: the two add the
# same values (exact in float64) in other orders, so they differ by
# rounding only, about 1.1e-16 times the square root of the values a thread
# adds (about 6,000 at (a)) times their partial sums, far below 1e-12.
K5_SUM_TOL = 1e-12
# Phase 5's remap shapes (width, height, depth in m): the reference demo
# (CLI/main.cpp:137) at the CLI's default depth, and BASELINE config 3
# (scripts/baseline_configs.py:10).  The float64 image is held to the remap
# core on CPU tensors over every GATE_ROW_STRIDE-th row within
# REMAP_F64_TOL of the image's largest magnitude (the same float64 math in
# another summation order); the float32 image to the float64 one within
# REMAP_F32_TOL of it (a Wachspress sum at float32 loses ~1e3 epsilon, as in
# the kernel check) with NaN masks and values agreeing on REMAP_F32_SHARE
# of pixels (a pixel on a cell edge or a layer interface may flip).
REMAP_SHAPES = ((3601, 1801, 10.0), (1201, 601, 20.0))
GATE_ROW_STRIDE = 16
REMAP_F64_TOL = 1e-9
REMAP_F32_TOL = 1e-4
REMAP_F32_SHARE = 0.999
# run_fixed_layer at FIXED_LAYER on config 3's image and run_regrid at
# REGRID_LAT, REGRID_WIDTH columns by the mesh's layers, both at float64.
FIXED_LAYER = 10
REGRID_LAT = 20.0
REGRID_WIDTH = 3601
# Phase 5c's CLI run.
CLI_ARGS = ["--synthetic", "20000", "--layers", "60", "--remap-size",
            "1201x601", "--samples", "31x31", "--dt", "120", "--duration",
            "86400"]
# Share of alive lanes' pathline attribute records that must be non-zero.
# A record is zero where every stage of its step failed, which at ocean
# speeds happens to a particle that relocation leaves outside its cell's
# polygon (it then stays there under FailMode.ZERO): about 1 % of lanes by
# the month's end.
ATTR_NONZERO = 0.98
# Phase 6's budget in seconds (logged beside its time), and BASELINE
# config 5's shape (scripts/baseline_configs.py:158-186): cells, layers,
# seeds, steps of 3600 s.
PHASE6_BUDGET = 300
CONFIG5 = (20_000, 20, 200_000, 100)
# Phase 7: its budget in seconds (logged beside its time), the time a group
# of worker processes (or a job the server runs) may take before it is
# killed and the phase fails, and the time the raw NCCL pair on one card
# may take (NCCL refuses it; a hang is killed and counted as refused).
# 7d's data folder (cells, layers, as phase 5c's CLI run) and its requests
# with the task each must route to.
PHASE7_BUDGET = 150
PHASE7_TIMEOUT = 300
NCCL_PAIR_TIMEOUT = 60
AGENT_MESH = (20_000, 60)
AGENT_REQUESTS = (("a 1-day streamline at depth of 10 m", "streamline"),
                  ("pathline between two snapshots", "pathline"),
                  ("remap to a 1201x601 image at depth of 20 m", "remapping"))
# Phase 8: the reference's vertical resolution (80 levels in its
# eddy-resolving meshes, BASELINE.md; MPASOVisualizerSYCL.cpp:100-101) on
# scripts/bench_refscale.py case A's mesh and seeds (cells, layers,
# particles) in the crossing regime; 8b's steps and gate lanes; the phase's
# budget in seconds (logged beside its time).
REFSCALE = (500_000, 80, 65_536)
REFSCALE_STEPS = 100
REFSCALE_GATE = 8192
PHASE8_BUDGET = 300
# Phase 6b's label of the run that 7c is held to.
REF_6B = "6b migrating streamline, migrate_every=8, K3"


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def smi_line():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def device_breakdown(run):
    """Run ``run`` under torch.profiler; return the device's busy time (the
    union of its event spans), the window from its first event to its last,
    the summed time per event name, all in milliseconds, and the longest
    idle gap as (ms, its start from the window's start in ms, the name of
    the event after it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        fail("torch.profiler saw no device activity")
    busy, end, per_name = 0.0, spans[0][0], {}
    gap = (0.0, 0.0, "")
    for start, stop, name in spans:
        if start - end > gap[0]:
            gap = (start - end, end - spans[0][0], name)
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        per_name[name] = per_name.get(name, 0.0) + (stop - start)
    return (busy / 1e3, (end - spans[0][0]) / 1e3,
            {k: v / 1e3 for k, v in per_name.items()},
            (gap[0] / 1e3, gap[1] / 1e3, gap[2]))


def step_bound(mesh, sols, seeds, cells, depths, n_attrs, tag,
               n_window=None):
    """The least time one fused step could take on this card at a main
    path's start inputs: (bound_ms, bound_by, bytes, operations), with the
    bytes and operations of mops_tpu_torch.advect.step_cost (the count
    the bench's roofline and bench_refscale's ``step_bytes`` read) over the
    card's memory rate and its peak rate for ``tag``'s type."""
    from mops_tpu_torch import advect
    nbytes, ops = advect.step_cost(mesh, sols, seeds, cells, depths, n_attrs,
                                   n_window or 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[tag] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def remap_row_gate(label, imgs, cpu_imgs, rows):
    """The card's float64 images at ``rows`` against the remap core's on CPU
    tensors (flattened rows): NaN masks equal, values within REMAP_F64_TOL
    of each card image's largest magnitude.  Returns the largest error
    relative to that magnitude."""
    import numpy as np
    worst = 0.0
    for k, (img, ref) in enumerate(zip(imgs, cpu_imgs)):
        got = img[rows].reshape(ref.shape)
        if not np.array_equal(np.isnan(got), np.isnan(ref)):
            fail(f"remap row gate {label} image {k}: NaN masks differ "
                 f"({int((np.isnan(got) != np.isnan(ref)).sum())} values)")
        finite = np.isfinite(ref)
        if not finite.any():
            fail(f"remap row gate {label} image {k}: no finite pixel")
        scale = float(np.nanmax(np.abs(img)))
        rel = float(np.abs(got - ref)[finite].max()) / scale
        log(f"  row gate {label} image {k}: {ref.shape[0]} pixels on "
            f"{len(rows)} rows, {100 * finite.mean():.3f}% finite values, "
            f"max |card - cpu| {rel:.3e} of the largest magnitude "
            f"{scale:.4e} (tol {REMAP_F64_TOL:.0e}), NaN masks equal")
        if not rel <= REMAP_F64_TOL:
            fail(f"remap row gate {label} image {k}")
        worst = max(worst, rel)
    return worst


def remap_f32_gate(label, imgs32, imgs64):
    """Each float32 image against its float64 image: the share of pixels
    whose NaN masks agree, and of common finite pixels within REMAP_F32_TOL
    of the float64 image's largest magnitude; both >= REMAP_F32_SHARE."""
    import numpy as np
    shares = []
    for k, (a, b) in enumerate(zip(imgs32, imgs64)):
        na, nb = np.isnan(a).any(-1), np.isnan(b).any(-1)
        mask_share = float((na == nb).mean())
        both = ~na & ~nb
        scale = float(np.nanmax(np.abs(b)))
        err = np.abs(a.astype(np.float64) - b).max(-1)[both]
        value_share = float((err <= REMAP_F32_TOL * scale).mean())
        log(f"  f32 vs f64 {label} image {k}: NaN masks agree on "
            f"{100 * mask_share:.4f}% of pixels, values within "
            f"{REMAP_F32_TOL:.0e} of {scale:.4e} on {100 * value_share:.4f}% "
            f"of {int(both.sum())} common finite pixels (max "
            f"{float(err.max()) / scale:.3e})")
        if mask_share < REMAP_F32_SHARE or value_share < REMAP_F32_SHARE:
            fail(f"remap f32 gate {label} image {k}")
        shares.append((mask_share, value_share))
    return shares


def compare_step(got, want, real, dt, flags=(3,), attr=None):
    """Kernel vs plain outputs of one step on identical inputs.  ``got`` and
    ``want`` are the wrappers' tuples: new_pos, hvel, wvel first; ``flags``
    the indices of the outputs that must agree exactly (ok, and layer and
    miss for the window kernels); ``attr`` the index of the attributes.

    Returns (errs, tol, flips, outliers, passed, note): per value output the
    largest difference over lanes that agree on every flag, the lanes that
    disagree on a flag, the lanes beyond tolerance (float32), whether the
    comparison passes, and the worst outlier lane's values."""
    import torch
    same = torch.ones_like(got[3], dtype=torch.bool)
    for i in flags:
        same &= got[i] == want[i]
    flips = int((~same).sum())
    idx = [0, 1, 2] + ([attr] if attr is not None else [])
    errs, lane_err, scale = [], [], []
    for i in idx:
        a, b = got[i], want[i]
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            fail("kernel and plain disagree on NaN lanes")
        d = (a - b).abs().nan_to_num(0.0)
        d = d if d.ndim == 1 else d.amax(dim=1)
        lane_err.append(torch.where(same, d, torch.zeros_like(d)))
        errs.append(float(lane_err[-1].max()))
        scale.append(float(b[same].abs().nan_to_num(0).max()))
    n = len(same)
    note = ""
    if real == torch.float32:
        tol = [F32_POS_TOL] + [F32_REL_TOL * x for x in scale[1:]]
        cap = [scale[1] * abs(dt)] + scale[1:]
        beyond = torch.zeros_like(same)
        capped = True
        for e, t, c in zip(lane_err, tol, cap):
            beyond |= e > t
            capped = capped and float(e.max()) <= c
        outliers = int(beyond.sum())
        passed = flips + outliers <= F32_OK_FLIPS * n and capped
        if outliers:
            j = int(torch.where(beyond, lane_err[1], torch.zeros_like(
                lane_err[1])).argmax())
            note = (f"; worst outlier lane {j}: ok {bool(got[3][j])} / "
                    f"{bool(want[3][j])}, hvel {got[1][j].tolist()} / "
                    f"{want[1][j].tolist()} (kernel / plain)")
    else:
        tol = list(F64_TOL) + ([F64_ATTR_TOL] if attr is not None else [])
        outliers = 0
        passed = flips == 0 and all(e <= t for e, t in zip(errs, tol))
    return errs, tol, flips, outliers, passed, note


def check_lanes(seeds, cells, depths, coc):
    """The kernel check's lanes from a main path's start inputs: (positions,
    cells, negative depths, window shifts) with lanes moved out of their
    cell, below the bottom, above the surface and dead (NaN), and the
    windows of some lanes moved a window off their layer."""
    import numpy as np
    idx = np.arange(len(seeds))
    cells_chk = cells.copy()
    move = (idx % 97 == 3) & (coc[cells, 0] >= 0)
    cells_chk[move] = coc[cells[move], 0]                 # out of cell
    depth_chk = -depths.astype(np.float64)
    depth_chk[idx % 89 == 5] = -5000.0                    # below the bottom
    depth_chk[idx % 83 == 7] = 5.0                        # above the surface
    seeds_chk = seeds.copy()
    seeds_chk[idx % 1009 == 11] = np.nan                  # dead lanes
    shift = np.where(idx % 61 == 17, WINDOW, np.where(idx % 61 == 29,
                                                      -WINDOW, 0))
    return seeds_chk, cells_chk, depth_chk, shift


def packed(mesh, sol, n_attrs=0):
    """The packed vertex table of ``sol`` with its first ``n_attrs``
    attributes."""
    from mops_tpu_torch import advect
    from mops_tpu_torch.kernels.stage_kernel import pack_vertex_table
    attrs = advect.stacked_vertex_attrs(sol)[..., :n_attrs] \
        if n_attrs else None
    return pack_vertex_table(mesh.vertex_xyz, sol.vertex_ztop,
                             sol.vertex_velocity, sol.vertex_vert_velocity,
                             attrs)


def start_windows(table, pos, dn, nv, vids, L):
    """Window starts around each lane's layer at its position, as
    run_advection places them (the full column's binary search on
    ``table``'s clamped profile)."""
    import torch

    from mops_tpu_torch.interp import wachspress_weights
    from mops_tpu_torch.step import (_clamp_profile, _layer_search_binary,
                                     window_starts)
    rows_ = table[vids.long()]
    w = wachspress_weights(pos, rows_[..., :3], nv)
    z = _clamp_profile(torch.einsum("nk,nkl->nl", w, rows_[..., 3:3 + L]),
                       True)
    return window_starts(_layer_search_binary(z, dn), L, WINDOW).contiguous()


def kernel_check(key, name, call, plain, dt, real, smi, row, where,
                 flags=(3,), attr=None, timed_case=False, timed_calls=None):
    """Hold ``call`` against ``plain``; on the timed case, time both per
    step (or the pair ``timed_calls``: the window kernels are timed at the
    main path's window starts) and record the times in ``row`` (unless
    None); with ``timed_case="euler"`` time the kernel alone (its one-stage
    form: RK4's time less Euler's is three stages' work)."""
    import torch
    from mops_tpu_torch.prof_dma import event_ms
    got = call()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    errs, tol, flips, outliers, passed, note = compare_step(
        got, want, real, dt, flags, attr)
    n = len(want[3])
    n_ok = int(want[3].sum())
    extra = f", {int(got[5].sum())} lanes missed" if 5 in flags else ""
    log(f"  {key} {name}: max|d new_pos| {errs[0]:.3e} m, hvel "
        f"{errs[1]:.3e} m/s, wvel {errs[2]:.3e} m/s"
        + (f", attrs {errs[3]:.3e}" if attr is not None else "")
        + f" (tol {', '.join(f'{t:.1e}' for t in tol)}); flag flips "
        f"{flips}, lanes beyond tol {outliers}, ok lanes {n_ok}/{n}"
        + extra + note)
    if not passed:
        fail(f"kernel check {key} {name} outside tolerance")
    if n_ok == 0 or n_ok == n:
        fail(f"kernel check {key} {name}: the edge lanes did not fail")
    if attr is not None and not bool((got[attr][got[3], :2] != 0).all()):
        fail(f"kernel check {key} {name}: zero attributes on ok lanes")
    if 5 in flags and not 0 < int(got[5].sum()) < n // 2:
        fail(f"kernel check {key} {name}: no lane missed its window")
    if not timed_case:
        return
    k_call, p_call = timed_calls or (call, plain)
    ms = event_ms(k_call, 20)
    if timed_case == "euler":
        log(f"  per step at {where}, {key} {name}: kernel {ms:.3f} ms ({smi})")
        if row is not None:
            row["euler_ms"] = ms
        return
    plain_ms = event_ms(p_call, 3)
    log(f"  per step at {where}, {key} {name}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms ({smi})")
    if row is not None:
        row.update(max_abs_err=errs[0], ms=ms, plain_ms=plain_ms)


def check_kernels(meshes, sols, lanes, L, smi, record, where,
                  alpha_sets=None, streamline=True, attr_counts=(0, 2)):
    """Phase 1's kernel checks (and 8a's and 8e's): K1 and K3 on the
    "stream" snapshot (unless not ``streamline``), K2 and K4 between
    "front" and "back" with each of ``attr_counts`` attributes, float32 and
    float64, RK4 and Euler, on ``lanes`` (check_lanes) in columns of L
    layers; ``record(key, real)`` gives the dict to record a kernel's times
    in (or None), and with ``record`` None nothing is timed;
    ``alpha_sets`` the pathline alphas by name (default: mid-run and near
    1, where the clip engages)."""
    import torch

    from mops_tpu_torch import advect
    from mops_tpu_torch.kernels import stage_kernel as sk
    f32, f64 = torch.float32, torch.float64
    seeds_chk, cells_chk, depth_chk, shift = lanes
    timed = record is not None
    record = record or (lambda key, real: None)

    def lane_inputs(real):
        mesh = meshes[real]
        dev = mesh.device
        vids, nv, _ = advect._gather_cell_vertices(
            mesh, torch.as_tensor(cells_chk, device=dev))
        pos = torch.as_tensor(seeds_chk, device=dev, dtype=real)
        dn = torch.as_tensor(depth_chk, device=dev, dtype=real)
        return pos, dn, nv, vids

    def starts(pos, dn, nv, vids, tab):
        """Window starts around each lane's layer, as run_advection places
        them (timed), and the same moved a window away on some lanes so that
        they miss (checked)."""
        s = start_windows(tab, pos, dn, nv, vids, L)
        moved = s.long() + torch.as_tensor(shift, device=pos.device)
        return s, torch.clamp(moved, 0, L - WINDOW).to(
            torch.int32).contiguous()

    if alpha_sets is None:
        alpha_sets = {"mid": (PATH_STEPS // 2) / PATH_STEPS,
                      "near 1": (PATH_STEPS - 1) / PATH_STEPS}
    for real, tag in ((f32, "f32"), (f64, "f64")):
        pos, dn, nv, vids = lane_inputs(real)
        if streamline:
            tab = packed(meshes[real], sols["stream", real])
            rise = sk.table_rise(tab, L)
            s0, s = starts(pos, dn, nv, vids, tab)
            for euler in (False, True):
                name = f"{tag} {'euler' if euler else 'rk4'}"
                timed_case = timed and ("euler" if euler else True)
                kernel_check("k1", name,
                             lambda: sk.fused_streamline_step(
                                 pos, dn, nv, vids, tab, L, 120.0,
                                 euler=euler),
                             lambda: sk.fused_streamline_step_plain(
                                 pos, dn, nv, vids, tab, L, 120.0,
                                 euler=euler),
                             120.0, real, smi, record("k1", real), where,
                             timed_case=timed_case)
                kernel_check("k3", name,
                             lambda: sk.fused_window_streamline_step(
                                 pos, dn, nv, vids, s, tab, rise, L, WINDOW,
                                 120.0, euler=euler),
                             lambda: sk.fused_window_streamline_step_plain(
                                 pos, dn, nv, vids, s, tab, rise, L, WINDOW,
                                 120.0, euler=euler),
                             120.0, real, smi, record("k3", real), where,
                             flags=(3, 4, 5, 6), timed_case=timed_case,
                             timed_calls=(
                                 lambda: sk.fused_window_streamline_step(
                                     pos, dn, nv, vids, s0, tab, rise, L,
                                     WINDOW, 120.0, euler=euler),
                                 lambda: sk.fused_window_streamline_step_plain(
                                     pos, dn, nv, vids, s0, tab, rise, L,
                                     WINDOW, 120.0)))
            del tab, rise
        for n_attrs in attr_counts:
            tf = packed(meshes[real], sols["front", real], n_attrs)
            tb = packed(meshes[real], sols["back", real], n_attrs)
            rises = sk.table_rise(tf, L), sk.table_rise(tb, L)
            sp0, sp = starts(pos, dn, nv, vids, tf)
            for euler in (False, True):
                for a_name, a1 in alpha_sets.items():
                    alphas = advect.stage_alphas(
                        a1, PATH_DT, PATH_DT * PATH_STEPS, real)
                    name = (f"{tag} {'euler' if euler else 'rk4'} "
                            f"A={n_attrs} alphas {a_name} "
                            f"{[float(a) for a in alphas]}")
                    timed_case = timed and n_attrs and a_name == "mid" \
                        and ("euler" if euler else True)
                    kernel_check("k2", name,
                                 lambda: sk.fused_pathline_step(
                                     pos, dn, nv, vids, tf, tb, L, PATH_DT,
                                     alphas, euler=euler, n_attrs=n_attrs),
                                 lambda: sk.fused_pathline_step_plain(
                                     pos, dn, nv, vids, tf, tb, L, PATH_DT,
                                     alphas, euler=euler, n_attrs=n_attrs),
                                 PATH_DT, real, smi, record("k2", real),
                                 where, attr=4 if n_attrs else None,
                                 timed_case=timed_case)
                    kernel_check("k4", name,
                                 lambda: sk.fused_window_pathline_step(
                                     pos, dn, nv, vids, sp, tf, tb, *rises, L,
                                     WINDOW, PATH_DT, alphas, euler=euler,
                                     n_attrs=n_attrs),
                                 lambda: sk.fused_window_pathline_step_plain(
                                     pos, dn, nv, vids, sp, tf, tb, *rises, L,
                                     WINDOW, PATH_DT, alphas, euler=euler,
                                     n_attrs=n_attrs),
                                 PATH_DT, real, smi, record("k4", real),
                                 where, flags=(3, 4, 5, 6),
                                 attr=7 if n_attrs else None,
                                 timed_case=timed_case,
                                 timed_calls=(
                                     lambda: sk.fused_window_pathline_step(
                                         pos, dn, nv, vids, sp0, tf, tb,
                                         *rises, L, WINDOW, PATH_DT, alphas,
                                         euler=euler, n_attrs=n_attrs),
                                     lambda: sk.fused_window_pathline_step_plain(
                                         pos, dn, nv, vids, sp0, tf, tb,
                                         *rises, L, WINDOW, PATH_DT, alphas,
                                         n_attrs=n_attrs)))
            del tf, tb, rises
        del pos, dn, nv, vids


def window_alone(pos, dn, nv, vids, s, tables, rises, L, W, dt, euler,
                 alphas=None, n_attrs=0):
    """The window step alone on these lanes (step.window_streamline_step,
    or window_pathline_step with ``alphas`` and two tables): the window's
    arithmetic with no repair, which is what the window kernels gave a
    lane before the clamp test flagged it.  Returns (new_pos, hvel, wvel,
    ok)."""
    import torch

    from mops_tpu_torch import step
    from mops_tpu_torch.kernels import stage_kernel as sk
    rmin = [step.cell_rise(r, vids, nv) for r in rises]
    vpos, _, cols_w, ends = sk._window_inputs(tables[0], vids, s, L, W,
                                              n_attrs)
    if alphas is None:
        return step.window_streamline_step(cols_w, ends, s, L, pos, dn, nv,
                                           vpos, dt, euler, rmin[0])[:4]
    _, _, cols_bw, _ = sk._window_inputs(tables[1], vids, s, L, W, n_attrs)
    a = tuple(torch.as_tensor(x, dtype=pos.dtype, device=pos.device)
              for x in alphas)
    return step.window_pathline_step(cols_w, cols_bw, ends, s, L, pos, dn,
                                     nv, vpos, dt, a, euler, tuple(rmin),
                                     n_attrs)[:4]


def parted(alone, full):
    """Lanes on which ``alone`` (new_pos, hvel, wvel, ok) parts from the
    full step's ``full``: ok different, NaN in one only, new positions more
    than F32_POS_TOL apart or velocities more than F32_REL_TOL of the full
    step's largest apart (the float32 kernel check's tolerances)."""
    scale = float(full[1].abs().nan_to_num(0).max()) if len(full[1]) else 0
    nan = lambda t: t.isnan().any(dim=1)
    return (alone[3] != full[3]) | (nan(alone[0]) != nan(full[0])) | (
        (alone[0] - full[0]).norm(dim=1).nan_to_num(0) > F32_POS_TOL) | (
        (alone[1] - full[1]).abs().amax(dim=1).nan_to_num(0)
        > F32_REL_TOL * scale)


class ClampProbe:
    """The parent-equivalent count of window-path runs: while active,
    advect's window steps call the wrappers as a run does, then step the
    alive lanes that only the clamp test flagged again through the window
    step alone (window_alone) and count them (``flagged``) and those on
    which it parts from the step the run took (``differed``, parted): the
    lane-steps on which the window kernels without the clamp test would
    have left the full column.  A flagged step costs a host sync and a few
    small torch ops, so the probe runs outside the timed runs, and a
    streamline's probe run takes the eager loop (run_advection's
    graph=False): a captured step may not wait on the device."""

    def __enter__(self):
        from mops_tpu_torch import advect
        self.flagged = self.differed = 0
        self._saved = adv, k3, k4 = (advect.advance,
                                     advect.fused_window_streamline_step,
                                     advect.fused_window_pathline_step)
        alive = {}

        def advance(st, p, i):
            alive["now"] = p.alive
            return adv(st, p, i)

        def count(out, args, tables, rises, L, W, dt, euler, alphas=None,
                  n_attrs=0):
            import torch
            idx = torch.nonzero(out[6] & alive["now"])[:, 0]
            if idx.numel():
                lanes = [a[idx] for a in args]
                alone = window_alone(*lanes, tables, rises, L, W, dt, euler,
                                     alphas, n_attrs)
                self.flagged += idx.numel()
                self.differed += int(parted(alone, [
                    t[idx] for t in out[:4]]).sum())

        def window_streamline(pos, dn, nv, vids, s, table, rise, L, W, dt,
                              euler=False):
            out = k3(pos, dn, nv, vids, s, table, rise, L, W, dt,
                     euler=euler)
            count(out, (pos, dn, nv, vids, s), (table,), (rise,), L, W, dt,
                  euler)
            return out

        def window_pathline(pos, dn, nv, vids, s, table_f, table_b, rise_f,
                            rise_b, L, W, dt, alphas, euler=False,
                            n_attrs=0):
            out = k4(pos, dn, nv, vids, s, table_f, table_b, rise_f, rise_b,
                     L, W, dt, alphas, euler=euler, n_attrs=n_attrs)
            count(out, (pos, dn, nv, vids, s), (table_f, table_b),
                  (rise_f, rise_b), L, W, dt, euler, alphas, n_attrs)
            return out

        advect.advance = advance
        advect.fused_window_streamline_step = window_streamline
        advect.fused_window_pathline_step = window_pathline
        return self

    def __exit__(self, *exc):
        from mops_tpu_torch import advect
        (advect.advance, advect.fused_window_streamline_step,
         advect.fused_window_pathline_step) = self._saved


# The step kernels' device names, as parts of their instances' names in a
# profile: K3, K1 (and K3's masked K1 repair), K4, K2 (and K4's repair).
STEP_KERNELS = ("window_streamline_kernel", "streamline_step_kernel",
                "window_pathline_kernel", "pathline_step_kernel")


def kernel_census(fn):
    """fn() under a CUDA-only torch.profiler, with the launch counts set to
    0 just before it: (its result, a record of the step kernels the device
    ran, counted by name in the trace ("traced", each of STEP_KERNELS),
    beside the launch counters ("launches", launch_counts()) and the steps
    replayed from a captured graph ("graph_steps")).  A graphed streamline
    adds its launch counters a replay at a time, not at a launch: the trace
    is what shows that every replay ran its kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mops_tpu_torch.kernels import stage_kernel as sk
    from mops_tpu_torch.utils.timer import TimerManager
    mgr = TimerManager.instance()
    sk.reset_counts()
    before = mgr.counter("advect.graph_steps")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return out, {
        "traced": {k: sum(k in nm for nm in names) for k in STEP_KERNELS},
        "launches": sk.launch_counts(),
        "graph_steps": mgr.counter("advect.graph_steps") - before}


def census_faults(rec, key, n_steps):
    """What in kernel_census's ``rec`` of a graphed streamline of
    ``n_steps`` steps on path ``key`` ("k3": K3 and its masked K1 repair a
    step; "k1": K1) differs from what its steps ask: each step kernel once
    a step in the trace and in the counters, and every step past
    advect.GRAPH_WARM_STEPS replayed.  [] when nothing does."""
    from mops_tpu_torch import advect
    from mops_tpu_torch.kernels import stage_kernel as sk
    traced = dict.fromkeys(STEP_KERNELS, 0)
    counted = dict.fromkeys(sk.COUNT_KEYS, 0)
    traced["streamline_step_kernel"] = counted[key] = n_steps
    if key == "k3":
        traced["window_streamline_kernel"] = counted["k3 repair"] = n_steps
    want = {"traced": traced, "launches": counted,
            "graph_steps": n_steps - advect.GRAPH_WARM_STEPS}
    return [f"{k} {rec[k]}, not {want[k]}" for k in want if rec[k] != want[k]]


def census_line(rec):
    return (f"traced step kernels {rec['traced']}, launch counters "
            f"{rec['launches']}, steps replayed {rec['graph_steps']}")


def miss_shares(raw, n_steps):
    """(edge, clamp) misses of a window-path run and their shares of its
    particle-steps: edge misses are the window misses that the clamp test
    did not flag alone."""
    total = int(raw.window_misses.sum())
    clamp = int(raw.window_clamp_misses.sum())
    steps = raw.window_misses.numel() * n_steps
    return {"edge": total - clamp, "clamp": clamp,
            "edge_share": (total - clamp) / steps,
            "clamp_share": clamp / steps}


def miss_line(m):
    return (f"window misses: edge {m['edge']} "
            f"({100 * m['edge_share']:.4f}% of particle-steps), clamp "
            f"{m['clamp']} ({100 * m['clamp_share']:.4f}%)")


def rising_columns(dev, smi, timed):
    """Phase 1b: the window kernels where raw ztop columns rise, on the
    bench's crossing-regime case of RISING_CASE at each of RISING_LAYERS
    (its field has a vertex column rising above the surface: the
    window-path fault of ROADMAP §3), with a back snapshot at omega
    1.2e-5.  At f32 and f64, RK4 and Euler, windows at each lane's start
    layer as run_advection places them: K3 and K4 (2 attributes, mid-run
    alphas) against their plain versions (compare_step; ok, layer, miss and
    clamp flags) and against K1 (K2) on every lane bit for bit, the flagged
    ones among them; the lanes the clamp test flags and on how many of them
    the window step alone would part from the full step (``parted``).  Then
    the traced gate (bench.gate, trace=True) of the window path on the first
    L's case over 20 steps, f32 and f64: no lane may part from identical
    states.  Returns the phase's summary."""
    import numpy as np
    import torch

    import mops_tpu_torch as mtt
    from mops_tpu_torch import advect, bench
    from mops_tpu_torch.kernels import stage_kernel as sk
    f32, f64 = torch.float32, torch.float64
    full_of = {"k3": "K1", "k4": "K2"}
    n_cells, n = RISING_CASE
    depths = mtt.seeding.linear_depth_profile(n, 10, 2500)
    alphas_mid = (PATH_STEPS // 2) / PATH_STEPS
    out = {}
    for L in RISING_LAYERS:
        inst = sk.column_instance(L)
        mesh_d, _, seeds, cells = timed(
            f"1b build the crossing case L{L}", lambda: bench.build_case(
                n_cells, L, n, device=dev, **bench.CROSSING))
        mesh_h = mtt.synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=0,
                                              n_layers=L)
        raws = [{k: np.asarray(v, np.float32) for k, v in
                 mtt.synth.solid_body_fields(mesh_h, n_layers=L, omega=om,
                                             **bench.CROSSING).items()}
                for om in (1e-5, 1.2e-5)]
        for real, tag in ((f32, "f32"), (f64, "f64")):
            mesh = mesh_d.to(dev, real)
            sols = [mtt.preprocess(mesh, raw, dtype=real, device=dev)
                    for raw in raws]
            vids, nv, _ = advect._gather_cell_vertices(
                mesh, torch.as_tensor(cells, device=dev))
            pos = torch.as_tensor(seeds, device=dev).to(real)
            dn = -torch.as_tensor(depths, device=dev).to(real)
            tab = packed(mesh, sols[0])
            tf, tb = packed(mesh, sols[0], 2), packed(mesh, sols[1], 2)
            rise = sk.table_rise(tab, L)
            rises = sk.table_rise(tf, L), sk.table_rise(tb, L)
            s = start_windows(tab, pos, dn, nv, vids, L)
            alphas = advect.stage_alphas(alphas_mid, PATH_DT,
                                         PATH_DT * PATH_STEPS, real)
            for euler in (False, True):
                name = f"L{L} ({inst} repair) {tag} " \
                    f"{'euler' if euler else 'rk4'}"
                for key in ("k3", "k4"):
                    if key == "k3":
                        args = (pos, dn, nv, vids, s, tab, rise, L, WINDOW,
                                120.0)
                        got = sk.fused_window_streamline_step(*args,
                                                              euler=euler)
                        want = sk.fused_window_streamline_step_plain(
                            *args, euler=euler)
                        full = sk.fused_streamline_step(
                            pos, dn, nv, vids, tab, L, 120.0, euler=euler)
                        pairs, dt, attr = list(zip(got[:4], full)), 120.0, None
                        alone_kw = dict(tables=(tab,), rises=(rise,), dt=dt)
                    else:
                        args = (pos, dn, nv, vids, s, tf, tb, *rises, L,
                                WINDOW, PATH_DT, alphas)
                        got = sk.fused_window_pathline_step(
                            *args, euler=euler, n_attrs=2)
                        want = sk.fused_window_pathline_step_plain(
                            *args, euler=euler, n_attrs=2)
                        full = sk.fused_pathline_step(
                            pos, dn, nv, vids, tf, tb, L, PATH_DT, alphas,
                            euler=euler, n_attrs=2)
                        pairs = list(zip(got[:4], full[:4])) + [
                            (got[7], full[4])]
                        dt, attr = PATH_DT, 7
                        alone_kw = dict(tables=(tf, tb), rises=rises, dt=dt,
                                        alphas=alphas, n_attrs=2)
                    torch.cuda.synchronize()
                    errs, tol, flips, outliers, passed, note = compare_step(
                        got, want, real, dt, (3, 4, 5, 6), attr)
                    same = torch.ones_like(got[3])
                    for a, b in pairs:
                        eq = a.nan_to_num(1.5) == b.nan_to_num(1.5)
                        same &= eq if eq.ndim == 1 else eq.all(dim=1)
                    miss, clamp = got[5], got[6]
                    idx = torch.nonzero(clamp)[:, 0]
                    lanes = [a[idx] for a in (pos, dn, nv, vids, s)]
                    alone = window_alone(*lanes, L=L, W=WINDOW, euler=euler,
                                         **alone_kw)
                    gone = int(parted(alone, [t[idx] for t in got[:4]]).sum())
                    row = {"edge": int((miss & ~clamp).sum()),
                           "clamp": int(clamp.sum()), "parted": gone,
                           "off_full": int((~same).sum()),
                           "off_full_flagged": int((~same & miss).sum()),
                           "flag_flips": flips, "beyond_tol": outliers}
                    out[f"{key} {name}"] = row
                    log(f"  1b {key} {name}: vs plain max|d new_pos| "
                        f"{errs[0]:.3e} m (tol {tol[0]:.1e}), flag flips "
                        f"{flips}, beyond tol {outliers}; lanes flagged: edge "
                        f"{row['edge']}, clamp {row['clamp']} (the window "
                        f"step alone parts from the full step on {gone}); "
                        f"lanes off {full_of[key]} bit for bit "
                        f"{row['off_full']} (flagged "
                        f"{row['off_full_flagged']}) of {n}" + note)
                    # at f32 one lane of the 2,048 may flip a flag or
                    # exceed the tolerance (tests/test_torch_cuda.py's rule)
                    passed = passed or (real == f32
                                        and flips + outliers <= 1)
                    if not passed or row["off_full"] or row["clamp"] == 0:
                        fail(f"1b {key} {name}: the window kernel on rising "
                             "columns")
            del tab, tf, tb, rise, rises, pos, dn, nv, vids, s, sols, mesh
        if L != RISING_LAYERS[0]:
            continue
        cfg = mtt.TrajectorySettings(
            delta_t=120, simulation_duration=120 * 20, record_t=120 * 20,
            particle_depths=depths, fail_mode=mtt.FailMode.ZERO)
        for real, tag in ((f32, "f32"), (f64, "f64")):
            mesh = mesh_d.to(dev, real)
            sol = mtt.preprocess(mesh, raws[0], dtype=real, device=dev)
            g = timed(f"1b traced gate L{L} {tag}", lambda: bench.gate(
                mesh, sol, seeds, cells, cfg, dtype=real, device=dev,
                use_window=True, trace=True))
            log(f"  1b traced gate L{L} {tag}, window path: "
                + bench.gate_line(g).lstrip("# ") + f" ({smi})")
            out[f"gate L{L} {tag}"] = {
                k: g[k] for k in ("share", "off", "identical_start",
                                  "verified")}
            if not g["verified"] or g["identical_start"]:
                fail(f"1b traced gate L{L} {tag}")
    return out


def window_ab(other):
    """``python3 chip_smoke.py --window-ab DIR``: K3 and K4 a launch, each
    with its masked repair, of this checkout against the checkout in DIR
    (say the parent commit, unpacked with git archive), in one process on
    one card.  DIR's mops_tpu_torch is imported under another name, so each
    library is built from its own source and both are loaded side by side.
    The inputs are phase 1's timed ones: the slice shape, the kernel check's
    lanes, windows at the main path's starts; K3 on the streamline field,
    K4 on the pathline pair with two attributes at mid-run alphas; f32 and
    f64.  CUDA events over 20 launches (prof_dma.event_ms), in the order
    this, other, other, this.  A checkout whose window wrappers take no
    first rises (one from before the clamp test) is called without them.
    Then phase 4's runs of the window paths (PROFILE_STEPS steps) through
    each checkout's run_advection under torch.profiler, in the same order:
    the window kernel's and the masked repair's device time a step.
    Prints a line a kernel and dtype, then one JSON object."""
    import importlib
    import importlib.util
    import inspect
    from pathlib import Path

    import torch

    import mops_tpu_torch as mtt
    from mops_tpu_torch import advect, prof_dma
    from mops_tpu_torch.kernels import stage_kernel as sk
    from mops_tpu_torch.prof_dma import (BACK_OMEGA, FIELD_KW, PATH_OMEGA,
                                         SLICE_LAYERS, event_ms)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the A/B needs a card")
    pkg = Path(other).resolve() / "mops_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_mops_tpu_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    sys.modules[spec.name] = module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    osk = importlib.import_module(f"{spec.name}.kernels.stage_kernel")
    smi = smi_line()
    log(f"window A/B: this checkout against {pkg.parent} ({smi})")
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(m.build) for m in (sk, osk)]:
            f.result()
    dev, L = torch.device("cuda"), SLICE_LAYERS
    mesh_h = prof_dma.slice_mesh()
    seeds = prof_dma.slice_seeds()
    cells = mtt.CellSearch(mesh_h).query(seeds)
    depths = mtt.seeding.linear_depth_profile(len(seeds), 10, 500)
    seeds_chk, cells_chk, depth_chk, _ = check_lanes(
        seeds, cells, depths, mesh_h.cells_on_cell.numpy())
    raws = {name: mtt.synth.solid_body_fields(
        mesh_h, n_layers=L, **FIELD_KW, **kw) for name, kw in (
            ("stream", {}), ("front", {"omega": PATH_OMEGA}),
            ("back", {"omega": BACK_OMEGA}))}
    out = {}
    for real, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        mesh = mesh_h.to(dev, real)
        sols = {k: mtt.preprocess(mesh, raw, dtype=real)
                for k, raw in raws.items()}
        vids, nv, _ = advect._gather_cell_vertices(
            mesh, torch.as_tensor(cells_chk, device=dev))
        pos = torch.as_tensor(seeds_chk, device=dev, dtype=real)
        dn = torch.as_tensor(depth_chk, device=dev, dtype=real)
        tables = {"k3": (packed(mesh, sols["stream"]),),
                  "k4": (packed(mesh, sols["front"], 2),
                         packed(mesh, sols["back"], 2))}
        alphas = advect.stage_alphas((PATH_STEPS // 2) / PATH_STEPS,
                                     PATH_DT, PATH_DT * PATH_STEPS, real)
        for key, tabs in tables.items():
            s = start_windows(tabs[0], pos, dn, nv, vids, L)
            rises = tuple(sk.table_rise(t, L) for t in tabs)
            calls = {}
            for name, mod in (("this", sk), ("other", osk)):
                fn = mod.fused_window_streamline_step if key == "k3" \
                    else mod.fused_window_pathline_step
                params = inspect.signature(fn).parameters
                extra = rises if "rise" in params or "rise_f" in params \
                    else ()
                rest = (L, WINDOW, 120.0) if key == "k3" \
                    else (L, WINDOW, PATH_DT, alphas)
                kw = {} if key == "k3" else {"n_attrs": 2}
                args = (pos, dn, nv, vids, s, *tabs, *extra, *rest)
                calls[name] = lambda fn=fn, args=args, kw=kw: fn(*args, **kw)
            ms = {"this": [], "other": []}
            for name in ("this", "other", "other", "this"):
                ms[name].append(event_ms(calls[name], 20))
            mean = {k: sum(v) / len(v) for k, v in ms.items()}
            log(f"  {key} {tag}: this {ms['this']} ms, other {ms['other']} "
                f"ms a launch with its repair; this / other "
                f"{mean['this'] / mean['other']:.4f} ({smi})")
            out[f"{key} {tag}"] = ms
            del tabs, rises, calls
        del tables, pos, dn, vids, nv
        for key, kname, repair, pathline in (
                ("k3", "window_streamline_kernel", "streamline_step_kernel",
                 False),
                ("k4", "window_pathline_kernel", "pathline_step_kernel",
                 True)):
            cfg = mtt.TrajectorySettings(
                delta_t=PATH_DT if pathline else 120,
                simulation_duration=(PATH_DT if pathline else 120)
                * PROFILE_STEPS, record_t=(PATH_DT if pathline else 120) * 3,
                particle_depths=depths, fail_mode=mtt.FailMode.ZERO)
            prof = {"this": [], "other": []}
            for name in ("this", "other", "other", "this"):
                pkg_ = mtt if name == "this" else module

                def run():
                    return pkg_.run_advection(
                        mesh, sols["front" if pathline else "stream"],
                        seeds, cells, cfg,
                        back=sols["back"] if pathline else None,
                        use_window=True)
                run()
                _, _, per_name, _ = device_breakdown(run)
                prof[name].append([
                    sum(v for nm, v in per_name.items() if kname in nm)
                    / PROFILE_STEPS,
                    sum(v for nm, v in per_name.items() if repair in nm)
                    / PROFILE_STEPS])
            log(f"  {key} {tag}, the main path's first {PROFILE_STEPS} "
                f"steps under torch.profiler, [window kernel, repair] ms a "
                f"step: this {prof['this']}, other {prof['other']} ({smi})")
            out[f"{key} {tag} profile"] = prof
        del sols, mesh
    log(json.dumps({"window_ab": out, "smi": smi}))


def front_door(dev, mesh_h, sols, seeds, cfg, pcfg, last_points, launches,
               reset_counts, timed, times, smi):
    """Phase 5: remap, the API and the CLI on ``dev`` at the slice's shape.
    ``sols`` maps (name, dtype) to phase 0's preprocessed fields,
    ``last_points`` phase 2's window paths' last points ("k3", "k4");
    ``launches`` reads K1-K5's launch counts (the repairs apart) and
    ``reset_counts`` zeroes them.  Returns the remap and API summaries."""
    import numpy as np
    import torch

    import mops_tpu_torch as mtt
    from mops_tpu_torch import advect, api, cli
    from mops_tpu_torch import remap as rm
    f32, f64 = torch.float32, torch.float64
    L = sols["front", f64].n_layers
    t_phase5 = time.perf_counter()
    log(f"[phase 5a] remap on the slice mesh at {REMAP_SHAPES}, f32 and f64, "
        f"with the pathline front's attributes")
    search = mtt.CellSearch(mesh_h)
    log(f"  CellSearch backend: {search.backend}")
    if search.backend != "native":
        fail("the native host cell search did not build on this machine")
    fields = {real: mtt.Field(mesh_h, sols["front", real], device=dev,
                              dtype=real, _search=search)
              for real in (f32, f64)}
    sol_cpu = sols["front", f64].to("cpu")
    attrs_cpu = advect.stacked_vertex_attrs(sol_cpu)
    remap_summary = {}

    def gate_rows(w, h, pix, pcells, stride=GATE_ROW_STRIDE):
        rows = np.arange(0, h, stride)
        idx = (rows[:, None] * w + np.arange(w)).ravel()
        return rows, torch.from_numpy(pix[idx]), torch.from_numpy(pcells[idx])

    def kd_query(label, vis, kind, make_pixels):
        t = time.perf_counter()
        out = rm._pixel_cells(fields[f64], vis, kind, make_pixels)
        times[f"5a {label} host cell query"] = time.perf_counter() - t
        log(f"  {label} host cell query ({len(out[1])} pixels, "
            f"{search.backend}): {times[f'5a {label} host cell query']:.3f} s")
        return out

    def native_vs_kdtree(label, pix, pcells):
        """The native search and cKDTree on the same pixels, each timed
        (build apart from query), their answers equal."""
        row = {}
        for backend, prefer in (("native", True), ("kdtree", False)):
            t = time.perf_counter()
            other = mtt.CellSearch(mesh_h, prefer_native=prefer)
            t_build = time.perf_counter() - t
            t = time.perf_counter()
            got = other.query(pix)
            row[backend] = {"build_s": t_build,
                            "query_s": time.perf_counter() - t}
            if other.backend != backend or not np.array_equal(got, pcells):
                fail(f"{label}: the {backend} search's answers differ")
        log(f"  {label}: host cell query, native "
            f"{row['native']['query_s']:.3f} s (grid build "
            f"{row['native']['build_s']:.3f} s) vs cKDTree "
            f"{row['kdtree']['query_s']:.3f} s (tree build "
            f"{row['kdtree']['build_s']:.3f} s), "
            f"{row['kdtree']['query_s'] / row['native']['query_s']:.2f} x; "
            f"the same cells")
        return row

    for w, h, depth in REMAP_SHAPES:
        vis = mtt.VisualizationSettings(image_width=w, image_height=h,
                                        fixed_depth=depth)
        label = f"remap {w}x{h} at {depth:g} m"
        pix, pcells = kd_query(label, vis, "remap",
                               lambda: rm._pixel_positions(vis))
        imgs, row = {}, {"pixels": w * h,
                         "host_query_s": times[f"5a {label} host cell query"]}
        if (w, h) == REMAP_SHAPES[0][:2]:
            row["native_vs_kdtree"] = native_vs_kdtree(label, pix, pcells)
        for real, tag in ((f32, "f32"), (f64, "f64")):
            first = timed(f"5a {label} {tag} first call",
                          lambda: rm.run_remapping(fields[real], vis))
            imgs[real] = timed(f"5a {label} {tag}",
                               lambda: rm.run_remapping(fields[real], vis))
            dev_s = times[f"5a {label} {tag}"]
            if len(first) != 2 or any(
                    im.shape != (h, w, 3) for im in imgs[real]) or not all(
                    np.array_equal(a, b, equal_nan=True)
                    for a, b in zip(first, imgs[real])):
                fail(f"{label} {tag}: shapes or repeat call")
            finite = float(np.isfinite(imgs[real][0][..., 2]).mean())
            log(f"  {label} {tag}: device {dev_s:.3f} s (first call "
                f"{times[f'5a {label} {tag} first call']:.3f} s, with the "
                f"upload), {w * h / dev_s:.6e} px/s; {100 * finite:.3f}% "
                f"ocean pixels ({smi})")
            if not 0.0 < finite:
                fail(f"{label} {tag}: no ocean pixel")
            row[tag] = {"device_s": dev_s, "px_per_s": w * h / dev_s,
                        "first_call_s": times[f"5a {label} {tag} first call"],
                        "ocean_share": finite}
            if (w, h) == REMAP_SHAPES[0][:2]:
                busy, window, per_name, gap = device_breakdown(
                    lambda: rm.run_remapping(fields[real], vis))
                top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
                log(f"  {label} {tag} under torch.profiler: device busy "
                    f"{busy:.3f} ms of a {window:.3f} ms window, idle share "
                    f"{100 * (1 - busy / window):.2f}%, longest gap "
                    f"{gap[0]:.3f} ms ({smi})")
                for name, ms in top:
                    log(f"    {ms:9.3f} ms {100 * ms / busy:6.2f}%  "
                        f"{name[:90]}")
                row[tag]["profile"] = {
                    "busy_ms": busy, "window_ms": window,
                    "top": [[nm[:90], ms] for nm, ms in top]}
        if (w, h) == REMAP_SHAPES[-1][:2]:
            rows, pos, cell = gate_rows(w, h, pix, pcells)
            vel, att = rm._fixed_depth_core(
                mesh_h, sol_cpu, attrs_cpu, pos, cell,
                torch.full((len(cell),), -depth, dtype=f64),
                depth_accurate=False, use_attrs=True)
            row["f64_vs_cpu_rows"] = remap_row_gate(
                label, imgs[f64], [vel.numpy(), att.numpy()], rows)
        row["f32_vs_f64"] = remap_f32_gate(label, imgs[f32], imgs[f64])
        remap_summary[f"{w}x{h}"] = row
        del imgs, first

    w, h, _ = REMAP_SHAPES[-1]
    vis = mtt.VisualizationSettings(image_width=w, image_height=h,
                                    fixed_layer=FIXED_LAYER)
    label = f"5a fixed layer {FIXED_LAYER} {w}x{h} f64"
    img = timed(label, lambda: rm.run_fixed_layer(fields[f64], vis))
    rows, pos, cell = gate_rows(w, h, *rm._pixel_cells(
        fields[f64], vis, "remap", lambda: rm._pixel_positions(vis)))
    remap_summary["fixed_layer"] = {
        "device_s": times[label],
        "f64_vs_cpu_rows": remap_row_gate(
            "fixed layer", [img], [rm._fixed_layer_batch(
                mesh_h, sol_cpu, pos, cell, FIXED_LAYER).numpy()], rows)}
    w = REGRID_WIDTH
    vis = mtt.VisualizationSettings(image_width=w, image_height=L,
                                    fixed_latitude=REGRID_LAT)
    label = f"regrid {w}x{L} at {REGRID_LAT:g} deg"
    pix, pcells = kd_query(label, vis, "regrid",
                           lambda: rm._regrid_positions(vis, L))
    img = timed(f"5a {label} f64", lambda: rm.run_regrid(fields[f64], vis))
    rows, pos, cell = gate_rows(w, L, pix, pcells)
    dn = torch.from_numpy(np.repeat(rm.regrid_depths(mesh_h, L)[rows], w))
    remap_summary["regrid"] = {
        "device_s": times[f"5a {label} f64"],
        "f64_vs_cpu_rows": remap_row_gate(
            "regrid", [img], [rm._fixed_lat_batch(
                mesh_h, sol_cpu, pos, cell, dn).numpy()], rows)}
    del fields, sol_cpu, attrs_cpu, img

    log("[phase 5b] the API on the card: MOPS_Init('cuda', 'fp32') with "
        "phase 2's fields; streamline day and pathline month")
    api.MOPS_Init(dev.type, "fp32")
    api.MOPS_ResetTiming()
    api.MOPS_Begin()
    api.MOPS_AddGridMesh(mesh_h)
    for sol_id, key in ((1, "stream"), (2, "front"), (3, "back")):
        api.MOPS_AddAttribute(sol_id, sols[key, f32])
    api.MOPS_End()
    api_summary = {}
    for label, key, ids, run, run_cfg in (
            ("MOPS_RunStreamLine", "k3", (1,), api.MOPS_RunStreamLine, cfg),
            ("MOPS_RunPathLine", "k4", (2, 3), api.MOPS_RunPathLine, pcfg)):
        api.MOPS_ActiveAttribute(*ids)
        pts = seeds.copy()
        reset_counts()
        lines = timed(f"5b {label}", lambda: run(run_cfg, pts))
        counts = launches()
        got = np.stack([line.last_point for line in lines])
        equal = bool(np.array_equal(got, last_points[key]))
        log(f"  {label}: {len(lines)} lines, launches {counts}; last points "
            f"bit-equal to phase 2's {key} path: {equal} ({smi})")
        if counts[key] != run_cfg.n_steps or sum(counts.values()) \
                != counts[key]:
            fail(f"{label}: launch counts {counts}")
        if not equal:
            diff = np.linalg.norm(got - last_points[key], axis=1)
            fail(f"{label}: last points differ from phase 2's on "
                 f"{int((diff > 0).sum())} lines (max {diff.max():.3e} m)")
        if label == "MOPS_RunPathLine" and not np.array_equal(pts, got):
            fail("MOPS_RunPathLine did not advance the seeds in place")
        api_summary[label] = {"seconds": times[f"5b {label}"],
                              "launches": counts[key]}
        if key == "k3":
            again, census = kernel_census(lambda: run(run_cfg, seeds.copy()))
            faults = census_faults(census, key, run_cfg.n_steps)
            same = np.array_equal(
                np.stack([line.last_point for line in again]), got)
            log(f"  {label} again under torch.profiler: "
                f"{census_line(census)}; last points bit-equal: {same}")
            if faults or not same:
                fail(f"{label}: the traced run: {faults}, bit-equal {same}")
            api_summary[label]["census"] = census
            del again
        del lines
    api.MOPS_PrintTimingSummary()
    api_summary["timing_ms"] = {
        c: api.MOPS_GetCategoryTime(c) for c in ("Preprocessing", "GPUKernel")}

    log(f"[phase 5c] the CLI in-process: {' '.join(CLI_ARGS)}")
    with tempfile.TemporaryDirectory() as out:
        rc = timed("5c cli", lambda: cli.main(CLI_ARGS + ["--out", out]))
        names = ("remap_east.png", "remap_north.png", "remap_speed.png",
                 "remap.vti", "streamline.vtp", "streamline.txt")
        sizes = {nm: os.path.getsize(os.path.join(out, nm))
                 for nm in names if os.path.exists(os.path.join(out, nm))}
        n_pts, n_lines = vtp_counts(os.path.join(out, "streamline.vtp"))
    args = dict(zip(CLI_ARGS[::2], CLI_ARGS[1::2]))
    n_rec = mtt.TrajectorySettings(
        delta_t=int(args["--dt"]), simulation_duration=int(args["--duration"]),
        record_t=60).n_records                        # the CLI's --record
    n_lat, n_lon = map(int, args["--samples"].split("x"))
    n_seeds = len(mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(n_lat, n_lon), lat_range=(20.0, 50.0),
        lon_range=(-80.0, -50.0))))                   # the CLI's --box
    log(f"  rc {rc}; files {sizes}; VTP {n_pts} points, {n_lines} lines "
        f"(expected {n_seeds} x {n_rec + 1} = {n_seeds * (n_rec + 1)})")
    if rc != 0 or len(sizes) != len(names) or min(sizes.values()) == 0 \
            or n_lines != n_seeds or n_pts != n_lines * (n_rec + 1):
        fail("CLI outputs")
    times["phase 5"] = time.perf_counter() - t_phase5
    log(f"  phase 5: {times['phase 5']:.3f} s")

    return remap_summary, api_summary


def write_nc3_dataset(folder, mesh, raws):
    """A data folder as the agent reads it, written with scipy (NetCDF-3,
    the MPAS layout of tests/test_torch_io.py): ``mesh.nc`` with the mesh
    variables and ``data_<t>.nc`` with snapshot t of ``raws`` (raw
    NetCDF-named fields, one Time entry each)."""
    import numpy as np
    from scipy.io import netcdf_file

    cpu = lambda t: t.detach().cpu().numpy()
    n_layers = raws[0]["layerThickness"].shape[1]
    dims = (("nCells", mesh.n_cells), ("nVertices", mesh.n_vertices),
            ("nEdges", mesh.n_edges), ("maxEdges", mesh.max_edges),
            ("vertexDegree", 3), ("TWO", 2), ("nVertLevels", n_layers),
            ("nVertLevelsP1", n_layers + 1), ("Time", 1), ("StrLen", 64))
    with netcdf_file(os.path.join(folder, "mesh.nc"), "w") as f:
        for name, size in dims:
            f.createDimension(name, size)
        for pre, arr, dim in (("Cell", mesh.cell_xyz, "nCells"),
                              ("Vertex", mesh.vertex_xyz, "nVertices"),
                              ("Edge", mesh.edge_xyz, "nEdges")):
            for k, ax in enumerate("xyz"):
                f.createVariable(ax + pre, "d", (dim,))[:] = cpu(arr)[:, k]
        f.createVariable("nEdgesOnCell", "i", ("nCells",))[:] = \
            cpu(mesh.n_edges_on_cell)
        for name, dim in (("verticesOnCell", ("nCells", "maxEdges")),
                          ("cellsOnCell", ("nCells", "maxEdges")),
                          ("cellsOnVertex", ("nVertices", "vertexDegree")),
                          ("edgesOnCell", ("nCells", "maxEdges")),
                          ("cellsOnEdge", ("nEdges", "TWO")),
                          ("verticesOnEdge", ("nEdges", "TWO"))):
            a = cpu(getattr(mesh, re.sub(r"([A-Z])", r"_\1", name).lower()))
            f.createVariable(name, "i", dim)[:] = np.where(a < 0, 0, a + 1)
        f.createVariable("refBottomDepth", "d", ("nVertLevels",))[:] = \
            np.linspace(100.0, 4000.0, n_layers) \
            if mesh.ref_bottom_depth is None else cpu(mesh.ref_bottom_depth)
    for t, raw in enumerate(raws):
        with netcdf_file(os.path.join(folder, f"data_{t:04d}.nc"), "w") as f:
            for name, size in dims:
                f.createDimension(name, size)
            f.createVariable("bottomDepth", "d", ("nCells",))[:] = \
                np.asarray(raw["bottomDepth"])
            for name, arr in raw.items():
                if name != "bottomDepth":
                    levels = "nVertLevelsP1" if name == "vertVelocityTop" \
                        else "nVertLevels"
                    f.createVariable(name, "d", ("Time", "nCells", levels))[
                        :] = np.asarray(arr)[None]
            xtime = np.zeros((1, 64), dtype="S1")
            xtime[0, :19] = list(f"0001-01-{t + 1:02d}_00:00:00".encode())
            f.createVariable("xtime", "c", ("Time", "StrLen"))[:] = xtime


def exchange_profile(run, smi):
    """Run ``run`` (a migrating run) once to warm up, then under
    torch.profiler with each exchange annotated: the exchanges' device time
    (the kernels their ops launched) against the device's busy time, and
    their host time against the profiled window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mops_tpu_torch.parallel import migrate
    exchange = migrate._exchange

    def annotated(*args):
        with record_function("migration exchange"):
            return exchange(*args)
    migrate._exchange = annotated
    try:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        migrate._exchange = exchange
    name = "migration exchange"
    events = prof.events()
    # the annotation shows on both timelines: its host range (whose
    # device_time_total sums the kernels its ops launched) and a device
    # range, which is no kernel and stays out of the busy time
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.name != name)
    if not spans:
        fail("torch.profiler saw no device activity")
    busy, end = 0.0, spans[0][0]
    for start, stop in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    ex = [e for e in events if e.name == name
          and e.device_type == DeviceType.CPU]
    if not ex:
        fail("the profiler saw no exchange")
    ex_dev = sum(e.device_time_total for e in ex) / 1e3
    ex_host = sum(e.cpu_time_total for e in ex) / 1e3
    busy, window = busy / 1e3, (end - spans[0][0]) / 1e3
    log(f"  exchange under torch.profiler, {len(ex)} exchanges: its kernels "
        f"{ex_dev:.3f} ms of {busy:.3f} ms busy ({100 * ex_dev / busy:.2f}%),"
        f" {ex_dev / len(ex):.4f} ms an exchange; host {ex_host:.3f} ms of a "
        f"{window:.3f} ms window ({100 * ex_host / window:.2f}%); idle share "
        f"{100 * (1 - busy / window):.2f}% ({smi})")
    if ex_dev <= 0.0:
        fail("the profiler saw no device time in the exchange")
    return {"device_ms": ex_dev, "busy_ms": busy, "host_ms": ex_host,
            "window_ms": window, "per_exchange_ms": ex_dev / len(ex),
            "exchanges": len(ex)}


def multi_device(dev, mesh_h, sols, seeds, cells, depths, cfg, pcfg, refs,
                 summary, launches, reset_counts, timed, times, smi):
    """Phase 6: the sharded and migrating engines on the card, their shards
    all on ``dev``.  ``refs`` holds phase 2's RawTrajectories by kernel
    (k3: 2a, k1: 2b, k4: 2c), ``summary`` phase 2's rates; 6b's
    migrate_every-8 window run is added to it as "6b k8".  Returns the
    phase's summary (launches per sub-phase, rates, shares)."""
    import numpy as np
    import torch

    import mops_tpu_torch as mtt
    from mops_tpu_torch import api
    from mops_tpu_torch.kernels import stage_kernel as sk
    from mops_tpu_torch.parallel import (partition_cells, reassemble,
                                         run_advection_migrating,
                                         run_advection_sharded)
    f32 = torch.float32
    n = len(seeds)
    mesh32 = mesh_h.to(dev, f32)
    t_phase6 = time.perf_counter()
    out = {}

    out["peak_gb"] = {}

    def begin():
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)

    def counts(label):
        """The sub-phase's launches; logs its peak device memory."""
        c = {**launches(), **sk.launch_counts()}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        out["peak_gb"][label] = peak
        log(f"  {label}: peak device memory {peak:.3f} GB")
        return c

    def expect(label, got, want):
        """Every kernel's launches in ``got`` as ``want`` says (0 where
        ``want`` has no entry)."""
        bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
        if bad:
            fail(f"{label}: launch counts {got}, expected {want}")

    def rate_line(label, seconds, steps, ref_key):
        rate = n * steps / seconds
        log(f"  {label}: {seconds:.3f} s, {rate:.6e} particle-RK4-steps/s "
            f"(phase 2 {ref_key}: "
            f"{summary[ref_key]['particle_rk4_steps_per_s']:.6e}) ({smi})")
        return rate

    def held(label, got, ref_key):
        """reassemble's trajectories ``got`` against phase 2's ``ref_key``
        run: points, velocities, attributes, final positions and depths
        bit for bit.  Returns the shares of final positions within 100 m
        and bit-equal, which it logs."""
        points, vels, attrs, fpos, fdepth = got
        ref = refs[ref_key]
        err = (fpos.double() - ref.final_position.double()).norm(dim=1)
        share = float((err <= 100.0).double().mean())
        bits = float((fpos == ref.final_position).all(dim=1).double().mean())
        equal = {"points": torch.equal(points, ref.points),
                 "velocities": torch.equal(vels, ref.velocities),
                 "final positions": torch.equal(fpos, ref.final_position),
                 "final depths": torch.equal(fdepth, ref.final_depth)}
        if ref.attrs is not None:
            equal["attributes"] = torch.equal(attrs, ref.attrs)
        log(f"  {label}: bit-equal to phase 2's {ref_key} run: {equal}; "
            f"{100 * share:.3f}% of final positions within 100 m, "
            f"{100 * bits:.3f}% bit-equal, median difference "
            f"{float(err.median()):.3e} m")
        if not all(equal.values()):
            fail(f"{label}: the trajectories differ from phase 2's")
        return share, bits

    def migration_checks(label, res, n_expect=n):
        fids = res.final_ids.cpu().numpy()
        ids = fids[fids >= 0]
        cap = fids.shape[1]
        occ = (fids >= 0).sum(axis=1) / cap
        dropped = int(res.dropped.sum())
        migrated = res.migrated.cpu().numpy()
        log(f"  {label}: migrated {int(migrated.sum())} (per shard "
            f"{migrated.tolist()}), dropped {dropped}, window misses "
            f"{int(res.window_misses.sum())}; pool occupancy min / median / "
            f"max {occ.min():.4f} / {float(np.median(occ)):.4f} / "
            f"{occ.max():.4f} of {cap} slots")
        if migrated.sum() == 0 or dropped != 0 or len(ids) != n_expect \
                or len(np.unique(ids)) != n_expect:
            fail(f"{label}: migration lost or duplicated particles")
        return {"migrated": int(migrated.sum()), "dropped": dropped,
                "window_misses": int(res.window_misses.sum()),
                "occupancy": [float(occ.min()), float(np.median(occ)),
                              float(occ.max())]}

    # ---- 6a: particle-sharded, 4 shards on the card -----------------------
    log(f"[phase 6a] run_advection_sharded: 4 shards on {dev}, the streamline"
        f" day through the window path (K3 and its K1 repair)")
    begin()
    raw = timed("6a sharded streamline", lambda: run_advection_sharded(
        mesh32, sols["stream", f32], seeds, cells, cfg, devices=[dev] * 4))
    got = counts("6a")
    steps = cfg.n_steps
    expect("6a", got, {"k3": 4 * steps, "k3 repair": 4 * steps})
    equal = all(torch.equal(getattr(raw, f), getattr(refs["k3"], f))
                for f in ("points", "velocities", "final_position",
                          "final_depth", "final_cell", "alive"))
    log(f"  launches {got}; positions and records bit-equal to phase 2a: "
        f"{equal}")
    if not equal:
        fail("6a: the sharded run differs from phase 2a")
    out["6a"] = {"launches": got, "rate": rate_line(
        "6a", times["6a sharded streamline"], steps, "k3")}
    del raw
    try:
        api.MOPS_Init(dev.type, "fp32", devices=torch.cuda.device_count() + 1)
    except RuntimeError as err:
        log(f"  MOPS_Init(devices={torch.cuda.device_count() + 1}) raised: "
            f"{err}")
    else:
        fail("MOPS_Init with more devices than cards did not raise")

    # ---- 6b: migrating streamline, 8 shards --------------------------------
    shards8 = [dev] * 8
    for k, windowed, key in ((1, True, "k3"), (8, True, "k3"),
                             (8, False, "k1")):
        label = f"6b migrating streamline, migrate_every={k}, {key.upper()}"
        log(f"[phase {label}] 8 shards on {dev}, the day")
        begin()
        res = timed(label, lambda: run_advection_migrating(
            mesh32, sols["stream", f32], seeds, cells, cfg, devices=shards8,
            dtype=f32, migrate_every=k, use_window=windowed))
        got = counts(label)
        want = {key: 8 * steps}
        if windowed:
            want[f"{key} repair"] = 8 * steps
        expect(label, got, want)
        row = migration_checks(label, res)
        row["within_100m"], row["bit_equal"] = held(
            label, reassemble(res, n, seeds), key)
        row["launches"] = got
        row["rate"] = rate_line(label, times[label], steps, key)
        out[f"6b k{k} {key}"] = row
        if (k, key) == (8, "k3"):
            refs["6b k8"] = res          # phase 7c's reference
        del res

    # the exchange's share of a step: torch.profiler over 30 steps
    prof_cfg = mtt.TrajectorySettings(
        delta_t=cfg.delta_t, simulation_duration=cfg.delta_t * PROFILE_STEPS,
        record_t=cfg.record_t, particle_depths=depths,
        fail_mode=mtt.FailMode.ZERO)
    out["exchange"] = exchange_profile(lambda: run_advection_migrating(
        mesh32, sols["stream", f32], seeds, cells, prof_cfg, devices=shards8,
        dtype=f32, migrate_every=1), smi)

    # ---- 6c: migrating pathline, the month --------------------------------
    label = "6c migrating pathline, migrate_every=8, K4"
    log(f"[phase {label}] 8 shards on {dev}, the month with both attributes")
    begin()
    res = timed(label, lambda: run_advection_migrating(
        mesh32, sols["front", f32], seeds, cells, pcfg, devices=shards8,
        dtype=f32, back=sols["back", f32], migrate_every=8))
    got = counts(label)
    psteps = pcfg.n_steps
    expect(label, got, {"k4": 8 * psteps, "k4 repair": 8 * psteps})
    row = migration_checks(label, res)
    traj = reassemble(res, n, seeds)
    row["within_100m"], row["bit_equal"] = held(label, traj, "k4")
    attrs, fpos = traj[2], traj[3]
    alive = torch.isfinite(fpos).all(dim=1)
    att = attrs[alive][:, :, :2]
    nonzero = float((att != 0).all(dim=2).double().mean())
    log(f"  attribute records finite: {bool(torch.isfinite(att).all())}, "
        f"non-zero on alive lanes: {100 * nonzero:.3f}%")
    if not bool(torch.isfinite(att).all()) or nonzero < ATTR_NONZERO:
        fail(f"{label}: attributes are not finite and non-zero")
    row.update(launches=got, attr_nonzero=nonzero,
               rate=rate_line(label, times[label], psteps, "k4"))
    out["6c"] = row
    del res, traj, attrs, fpos, att

    # ---- 6d: forced send overflow ------------------------------------------
    # 64 identical equatorial seeds in shard 0's cell nearest shard 1's west
    # edge: the eastward flow carries them all across in one step
    owner = partition_cells(mesh_h, 8)
    cx = mesh_h.cell_xyz.numpy()
    lon_c = np.arctan2(cx[:, 1], cx[:, 0])
    search = mtt.CellSearch(mesh_h)
    for west in np.deg2rad(np.arange(0.5, 20.0, 0.5)):
        lons = np.full(64, lon_c[owner == 1].min() - west)
        band = mtt.geo.latlon_rad_to_xyz(
            torch.zeros(64, dtype=torch.float64),
            torch.from_numpy(lons)).numpy()
        band_cells = search.query(band)
        if owner[band_cells[0]] == 0:
            break
    ocfg = mtt.TrajectorySettings(delta_t=cfg.delta_t,
                                  simulation_duration=cfg.simulation_duration,
                                  record_t=cfg.record_t, depth=100.0,
                                  fail_mode=mtt.FailMode.ZERO)
    label = "6d forced overflow, send_capacity=1"
    log(f"[phase {label}] 64 seeds {np.rad2deg(west):.1f} deg west of "
        f"shard 1, 8 shards")
    begin()
    res = timed(label, lambda: run_advection_migrating(
        mesh32, sols["stream", f32], band, band_cells, ocfg, devices=shards8,
        dtype=f32, send_capacity=1, capacity_factor=9.0))
    got = counts(label)
    expect(label, got, {"k3": 8 * steps, "k3 repair": 8 * steps})
    fids = res.final_ids.cpu().numpy().ravel()
    ok = fids >= 0
    survivors = fids[ok]
    dropped = int(res.dropped.sum())
    single = mtt.run_advection(mesh32, sols["stream", f32], band, band_cells,
                               ocfg, device=dev)
    fpos = res.final_pos.reshape(-1, 3)[torch.from_numpy(ok).to(dev)]
    err = (fpos.double() - single.final_position[
        torch.from_numpy(survivors).to(dev).long()].double()).norm(dim=1)
    log(f"  dropped {dropped}, survivors {len(survivors)} "
        f"({len(np.unique(survivors))} distinct), migrated "
        f"{int(res.migrated.sum())}; survivors' final positions vs the "
        f"single-device run: max {float(err.max()):.3e} m, "
        f"{100 * float((err == 0).double().mean()):.3f}% bit-equal")
    if dropped == 0 or len(survivors) + dropped != 64 \
            or len(np.unique(survivors)) != len(survivors) \
            or not bool((err <= 100.0).all()):
        fail(f"{label}: losses not accounted")
    out["6d"] = {"dropped": dropped, "survivors": len(survivors),
                 "max_err_m": float(err.max()), "launches": got}
    del res, single

    # ---- 6e: BASELINE config 5 at its own shape ----------------------------
    label = "6e BASELINE config 5"
    log(f"[phase {label}] scripts/baseline_configs.py:158-186: 20,000 "
        f"cells, L20, 200,000 uniform seeds, dt 3600 s, 100 steps, "
        f"migrate_every=8, 8 shards")
    n_cells5, n_layers5, n_seeds5, steps5 = CONFIG5
    mesh5 = mtt.synth.build_voronoi_mesh(n_cells5, jitter=0.05,
                                         n_layers=n_layers5)
    raw5 = mtt.synth.solid_body_fields(mesh5, n_layers=n_layers5,
                                       w_scale=1e-5)
    mesh5 = mesh5.to(dev, f32)
    sol5 = mtt.preprocess(mesh5, {k: np.asarray(v, np.float32)
                                  for k, v in raw5.items()}, dtype=f32,
                          device=dev)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n_seeds5, 3))
    seeds5 = (v / np.linalg.norm(v, axis=1, keepdims=True)
              * mtt.EARTH_RADIUS).astype(np.float32)
    cells5 = mtt.CellSearch(mesh5).query(seeds5)
    cfg5 = mtt.TrajectorySettings(delta_t=3600,
                                  simulation_duration=3600 * steps5,
                                  record_t=3600 * 25, depth=50.0,
                                  fail_mode=mtt.FailMode.ZERO)
    begin()
    res = timed(label, lambda: run_advection_migrating(
        mesh5, sol5, seeds5, cells5, cfg5, devices=shards8, dtype=f32,
        migrate_every=8))
    got = counts(label)
    expect(label, got, {"k3": 8 * steps5, "k3 repair": 8 * steps5})
    row = migration_checks(label, res, n_seeds5)
    rate = n_seeds5 * steps5 / times[label]
    log(f"  {label}: {rate:.6e} particle-RK4-steps/s (decomposition "
        f"included), dropped {row['dropped']} ({smi})")
    row.update(rate=rate, launches=got)
    out["6e"] = row
    del res

    times["phase 6"] = time.perf_counter() - t_phase6
    log(f"  phase 6: {times['phase 6']:.3f} s (budget {PHASE6_BUDGET} s)")
    out["seconds"] = times["phase 6"]
    return out


def _worker_results(results, label):
    """Each worker's "PHASE7 {json}" lines; fails on a worker that failed."""
    out = []
    for rank, (rc, stdout, stderr) in enumerate(results):
        if rc != 0:
            fail(f"{label}: worker {rank} exited {rc}:\n{stdout[-3000:]}\n"
                 f"{stderr[-3000:]}")
        out.append([json.loads(line[len("PHASE7 "):])
                    for line in stdout.splitlines()
                    if line.startswith("PHASE7 ")])
    return out


def _sync(dev):
    """Wait for ``dev`` (a card; the CPU has nothing to wait for)."""
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_exchange(stats):
    """Wrap migrate's block transport so that each call is counted and
    timed between two synchronisations (stats["calls"], stats["s"])."""
    from mops_tpu_torch.parallel import migrate
    inner = migrate.exchange_blocks

    def timed(send, group):
        _sync(send.device)
        t = time.perf_counter()
        out = inner(send, group)
        _sync(send.device)
        stats["calls"] += 1
        stats["s"] += time.perf_counter() - t
        return out
    migrate.exchange_blocks = timed
    return inner


def phase7_worker(args):
    """One rank of phase 7a/7b (``args["mode"]`` "gloo"), or of the raw NCCL
    pair on one card ("nccl-pair").  Prints its results as "PHASE7 {json}"
    lines."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world = args["rank"], args["world"]
    url = f"tcp://localhost:{args['port']}"
    if args["mode"] == "nccl-pair":
        # torch.distributed directly, past init_distributed's refusal
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=url, world_size=world,
                                rank=rank)
        t = torch.ones(1, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print("PHASE7 " + json.dumps({"all_reduce": float(t)}), flush=True)
        dist.destroy_process_group()
        return 0

    import mops_tpu_torch as mtt
    from mops_tpu_torch.kernels import stage_kernel as sk
    from mops_tpu_torch.mesh import MPASMesh
    from mops_tpu_torch.parallel import (gather_migrating,
                                         gather_trajectories,
                                         init_distributed, rank_bounds,
                                         reassemble, run_advection_migrating)
    from mops_tpu_torch.parallel.distributed import transport
    from mops_tpu_torch.solution import SolutionFields

    torch.set_num_threads(2)
    data = torch.load(os.path.join(args["dir"], "inputs.pt"),
                      weights_only=True)
    ref = torch.load(os.path.join(args["dir"], "ref_2a.pt"), mmap=True,
                     weights_only=True)
    group, devices = init_distributed(url, world, rank, backend="gloo",
                                      devices=[args["device"]]
                                      * args["per_rank"])
    dev, f32 = devices[0], torch.float32
    mesh = MPASMesh(**data["mesh"]).to(dev, f32)
    sol = SolutionFields(**data["sol"]).to(dev)
    seeds, cells = data["seeds"].numpy(), data["cells"].numpy()
    n = len(seeds)
    cfg = mtt.TrajectorySettings(
        delta_t=args["dt"], simulation_duration=args["dt"] * args["steps"],
        record_t=args["record"], particle_depths=data["depths"].numpy(),
        fail_mode=mtt.FailMode.ZERO)
    sync = lambda: _sync(dev)
    fields = ("points", "velocities", "final_position", "final_depth",
              "final_cell", "alive")
    out = {"rank": rank, "transport": transport(group, dev)}

    # 7a: this rank's slice through run_advection's window path, on one
    # card; then the whole gathered on rank 0
    sk.reset_counts()
    sync()
    t = time.perf_counter()
    raw = mtt.run_advection(mesh, sol, seeds, cells, cfg, use_window=True,
                            devices=[dev], group=group)
    sync()
    loop_s = time.perf_counter() - t
    a, b = rank_bounds(n, group)
    rows_equal = all(torch.equal(getattr(raw, f), ref[f][a:b].to(dev))
                     for f in fields)
    launches = sk.launch_counts()
    sync()
    t = time.perf_counter()
    whole = gather_trajectories(raw, n, group)
    sync()
    gather_s = time.perf_counter() - t
    whole_equal = None if whole is None else all(
        torch.equal(getattr(whole, f), ref[f].to(dev)) for f in fields)
    del raw, whole
    again, census = kernel_census(lambda: mtt.run_advection(
        mesh, sol, seeds, cells, cfg, use_window=True, devices=[dev],
        group=group))
    census["rows_equal"] = all(torch.equal(getattr(again, f),
                                           ref[f][a:b].to(dev))
                               for f in fields)
    del again
    out["7a"] = {"rows": [a, b], "loop_s": loop_s, "gather_s": gather_s,
                 "launches": launches, "rows_equal": rows_equal,
                 "whole_equal": whole_equal, "census": census}
    print("PHASE7 " + json.dumps(out), flush=True)

    # 7b: the migrating engine, this rank's shards of world x per_rank
    stats = {"calls": 0, "s": 0.0}
    from mops_tpu_torch.parallel import migrate
    inner = _timed_exchange(stats)
    sk.reset_counts()
    try:
        sync()
        t = time.perf_counter()
        res = run_advection_migrating(mesh, sol, seeds, cells, cfg,
                                      devices=devices, dtype=f32,
                                      migrate_every=args["migrate_every"],
                                      use_window=True, group=group)
        sync()
        run_s = time.perf_counter() - t
    finally:
        migrate.exchange_blocks = inner
    launches = sk.launch_counts()
    t = time.perf_counter()
    whole = gather_migrating(res, group)
    sync()
    row = {"run_s": run_s, "gather_s": time.perf_counter() - t,
           "launches": launches, "exchange_calls": stats["calls"],
           "exchange_s": stats["s"],
           "migrated": res.migrated.tolist(), "dropped": res.dropped.tolist()}
    if whole is not None:
        fids = whole.final_ids.cpu().numpy().ravel()
        ids = fids[fids >= 0]
        points, vels, _, fpos, fdepth = reassemble(whole, n, seeds)
        row.update(
            ids_once=bool(len(ids) == n and len(np.unique(ids)) == n),
            dropped_total=int(whole.dropped.sum()),
            migrated_total=int(whole.migrated.sum()),
            equal={"points": torch.equal(points, ref["points"].to(dev)),
                   "velocities": torch.equal(vels,
                                             ref["velocities"].to(dev)),
                   "final positions": torch.equal(
                       fpos, ref["final_position"].to(dev)),
                   "final depths": torch.equal(
                       fdepth, ref["final_depth"].to(dev))})
    print("PHASE7 " + json.dumps({"rank": rank, "7b": row}), flush=True)
    dist.destroy_process_group()
    return 0


def multi_process(dev, mesh_h, sols, seeds, cells, depths, cfg, refs,
                  timed, times, smi):
    """Phase 7a-7c: the engines across processes on the one card.  ``refs``
    holds phase 2a's RawTrajectories ("k3") and phase 6b's migrate_every-8
    window run ("6b k8").  Returns the phases' summary."""
    import dataclasses

    import torch

    from mops_tpu_torch.kernels import stage_kernel as sk
    from mops_tpu_torch.parallel import (gather_migrating, init_distributed,
                                         run_advection_migrating)
    from mops_tpu_torch.parallel.distributed import transport
    from mops_tpu_torch.utils.subproc import free_port, run_workers

    f32 = torch.float32
    n, steps = len(seeds), cfg.n_steps
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the workers load phase 2's host mesh, fields, seeds and cells
        # (not rebuilt: 21-29 s) and 2a's results, and the kernel library
        # from _build (same source hash: not rebuilt)
        t = time.perf_counter()
        sol = sols["stream", f32].to("cpu")
        torch.save({
            "mesh": {f.name: getattr(mesh_h, f.name)
                     for f in dataclasses.fields(mesh_h)},
            "sol": {f.name: getattr(sol, f.name)
                    for f in dataclasses.fields(sol)},
            "seeds": torch.as_tensor(seeds), "cells": torch.as_tensor(cells),
            "depths": torch.as_tensor(depths)},
            os.path.join(tmp, "inputs.pt"))
        torch.save({f: getattr(refs["k3"], f).cpu() for f in (
            "points", "velocities", "final_position", "final_depth",
            "final_cell", "alive")}, os.path.join(tmp, "ref_2a.pt"))
        times["7 save inputs"] = time.perf_counter() - t
        log(f"  phase 7 inputs saved for the workers: "
            f"{times['7 save inputs']:.3f} s")

        # ---- 7a/7b: 2 ranks over gloo, both on the card --------------------
        world, per_rank, k_mig = 2, 4, 8
        log(f"[phase 7a/7b] {world} processes over gloo, both on {dev}: the "
            f"streamline day sharded (one slice a rank), then migrating "
            f"({world} x {per_rank} shards, migrate_every={k_mig})")
        port = free_port()
        cmds = [[sys.executable, os.path.abspath(__file__), "--phase7-worker",
                 json.dumps({"mode": "gloo", "rank": r, "world": world,
                             "port": port, "dir": tmp, "per_rank": per_rank,
                             "device": str(dev),
                             "migrate_every": k_mig, "dt": int(cfg.delta_t),
                             "steps": steps, "record": int(cfg.record_t)})]
                for r in range(world)]
        t = time.perf_counter()
        results, timed_out = run_workers(cmds, PHASE7_TIMEOUT, tmp)
        times["7ab wall"] = time.perf_counter() - t
        if timed_out:
            fail(f"7a/7b: a worker hung past {PHASE7_TIMEOUT} s (killed)")
        rows = _worker_results(results, "7a/7b")
        a_rows = [next(r["7a"] for r in rank if "7a" in r) for rank in rows]
        b_rows = [next(r["7b"] for r in rank if "7b" in r) for rank in rows]
        used = {next(r["transport"] for r in rank if "transport" in r)
                for rank in rows}
        log(f"  7a/7b: wall {times['7ab wall']:.3f} s for both (process "
            f"start, CUDA set-up and the input load included); transport "
            f"{sorted(used)}")
        for r, row in enumerate(a_rows):
            log(f"  7a rank {r}: rows {row['rows']}, step loop "
                f"{row['loop_s']:.3f} s, gather {row['gather_s']:.3f} s, "
                f"launches {row['launches']}; rows bit-equal to 2a's: "
                f"{row['rows_equal']}" + ("" if row["whole_equal"] is None
                                          else f"; the gathered whole "
                                          f"bit-equal to 2a: "
                                          f"{row['whole_equal']}"))
            if not row["rows_equal"] or row["whole_equal"] is False:
                fail(f"7a rank {r}: its rows differ from phase 2a's")
            if row["launches"] != dict(dict.fromkeys(sk.COUNT_KEYS, 0),
                                       k3=steps, **{"k3 repair": steps}):
                fail(f"7a rank {r}: launches {row['launches']}")
            census = row["census"]
            faults = census_faults(census, "k3", steps)
            log(f"  7a rank {r} again under torch.profiler: "
                f"{census_line(census)}; rows bit-equal to 2a's: "
                f"{census['rows_equal']}")
            if faults or not census["rows_equal"]:
                fail(f"7a rank {r}: the traced run: {faults}, rows bit-equal "
                     f"{census['rows_equal']}")
        if a_rows[0]["whole_equal"] is not True:
            fail("7a: rank 0 did not gather the whole")
        loop = max(row["loop_s"] for row in a_rows)
        out["7a"] = {"ranks": a_rows, "wall_s": times["7ab wall"],
                     "rate": n * steps / loop}
        log(f"  7a: {n * steps / loop:.6e} particle-RK4-steps/s over the "
            f"slower rank's step loop ({loop:.3f} s; the two share the "
            f"card) ({smi})")
        n_ex = -(-steps // k_mig)
        for r, row in enumerate(b_rows):
            log(f"  7b rank {r}: run {row['run_s']:.3f} s, gather "
                f"{row['gather_s']:.3f} s, launches {row['launches']}; "
                f"{row['exchange_calls']} all_to_all_single calls "
                f"({n_ex} exchanges x 2 payloads), "
                f"{1e3 * row['exchange_s'] / max(1, n_ex):.3f} ms an "
                f"exchange (gloo through pinned host buffers on one card, "
                f"between two synchronisations: it says nothing of NCCL) "
                f"({smi})")
            want = dict(dict.fromkeys(sk.COUNT_KEYS, 0), k3=per_rank * steps,
                        **{"k3 repair": per_rank * steps})
            if row["launches"] != want or row["exchange_calls"] != 2 * n_ex:
                fail(f"7b rank {r}: launches {row['launches']} or "
                     f"{row['exchange_calls']} collectives")
        b0 = b_rows[0]
        log(f"  7b: migrated {b0['migrated_total']}, dropped "
            f"{b0['dropped_total']}, every id once {b0['ids_once']}; rank 0's "
            f"reassembled records bit-equal to 2a: {b0['equal']}")
        if not b0["ids_once"] or b0["dropped_total"] != 0 \
                or b0["migrated_total"] == 0 or not all(b0["equal"].values()):
            fail("7b: the migrating run across processes differs from 2a")
        run = max(row["run_s"] for row in b_rows)
        out["7b"] = {"ranks": b_rows, "rate": n * steps / run,
                     "exchange_ms": [1e3 * row["exchange_s"] / max(1, n_ex)
                                     for row in b_rows]}
        log(f"  7b: {n * steps / run:.6e} particle-RK4-steps/s over the "
            f"slower rank's run ({run:.3f} s, decomposition included) "
            f"({smi})")

        # ---- 7c: NCCL at world size 1, 8 shards on the card ---------------
        label = "7c NCCL world 1, 8 shards, migrate_every=8"
        log(f"[phase {label}] every exchange an all_to_all_single over NCCL")
        group, devs = init_distributed(f"tcp://localhost:{free_port()}", 1,
                                       0, backend="nccl", devices=[dev] * 8)
        try:
            stats = {"calls": 0, "s": 0.0}
            from mops_tpu_torch.parallel import migrate
            inner = _timed_exchange(stats)
            sk.reset_counts()
            try:
                res = timed(label, lambda: run_advection_migrating(
                    mesh_h.to(dev, f32), sols["stream", f32], seeds, cells,
                    cfg, devices=devs, dtype=f32, migrate_every=8,
                    use_window=True, group=group))
            finally:
                migrate.exchange_blocks = inner
            got = sk.launch_counts()
            whole = gather_migrating(res, group)
            ref = refs["6b k8"]
            equal = {f.name: torch.equal(getattr(whole, f.name),
                                         getattr(ref, f.name))
                     for f in dataclasses.fields(ref)
                     if getattr(ref, f.name) is not None}
            used = transport(group, dev)
        finally:
            torch.distributed.destroy_process_group()
        n_ex = -(-steps // 8)
        log(f"  {label}: transport {used}; launches {got}; "
            f"{stats['calls']} collectives, "
            f"{1e3 * stats['s'] / n_ex:.3f} ms an exchange; "
            f"{n * steps / times[label]:.6e} particle-RK4-steps/s (6b's "
            f"in-process run: {times[REF_6B]:.3f} s); bit-equal to 6b's "
            f"migrate_every-8 run: {equal} ({smi})")
        if not all(equal.values()) or stats["calls"] != 2 * n_ex \
                or used != "nccl" or got["k3"] != 8 * steps:
            fail(f"{label}: differs from 6b or did not go through NCCL")
        out["7c"] = {"launches": got, "exchange_ms": 1e3 * stats["s"] / n_ex,
                     "rate": n * steps / times[label]}
        del res, whole

        # NCCL and two ranks on one card: refused up front, and by NCCL
        try:
            init_distributed(f"tcp://localhost:{free_port()}", 2, 0,
                             backend="nccl")
        except RuntimeError as err:
            msg = str(err)
        else:
            fail("init_distributed put two NCCL ranks on one card")
        log(f"  init_distributed(world 2, nccl) on one card raised: {msg}")
        if "NCCL cannot put two ranks on one card" not in msg \
                or torch.cuda.get_device_name(0) not in msg:
            fail("init_distributed's refusal does not name the card")
        port = free_port()
        cmds = [[sys.executable, os.path.abspath(__file__), "--phase7-worker",
                 json.dumps({"mode": "nccl-pair", "rank": r, "world": 2,
                             "port": port})] for r in range(2)]
        t = time.perf_counter()
        results, timed_out = run_workers(cmds, NCCL_PAIR_TIMEOUT, tmp)
        pair_s = time.perf_counter() - t
        said = sorted({m.strip() for _, o, e in results for m in re.findall(
            r"[^\n]*[Dd]uplicate GPU[^\n]*", o + e)})
        log(f"  NCCL itself, two ranks on {dev} (torch.distributed "
            f"directly): exit codes {[rc for rc, _, _ in results]}, "
            f"{'hung until killed, ' if timed_out else ''}{pair_s:.3f} s; "
            f"NCCL said: {said or 'no duplicate-GPU message'}")
        if not timed_out and all(rc == 0 for rc, _, _ in results):
            fail("NCCL ran two ranks on one card: init_distributed's refusal"
                 " is wrong")
        out["nccl_pair"] = {"returncodes": [rc for rc, _, _ in results],
                            "timed_out": timed_out, "message": said}
    return out


def agent_front_end(dev, times, smi):
    """Phase 7d: the port's server in a thread, three tasks run as jobs on
    the card from NetCDF-3 files of a synthetic mesh.  The server's job
    runner is wrapped to read each job process's launch counts."""
    import urllib.request

    import torch

    import mops_tpu_torch as mtt
    from mops_tpu_torch import agent
    from mops_tpu_torch.frontend import serve
    from mops_tpu_torch.kernels import stage_kernel as sk
    from mops_tpu_torch.utils.subproc import package_env

    out = {}
    n_cells, n_layers = AGENT_MESH
    runner = ("import json, runpy, sys\n"
              "runpy.run_path(sys.argv[1], run_name='__main__')\n"
              "from mops_tpu_torch.kernels.stage_kernel import "
              "launch_counts\n"
              "print('PHASE7 ' + json.dumps(launch_counts()))\n")
    jobs = []

    def counted_job(script):
        proc = subprocess.run([sys.executable, "-c", runner, script],
                              env=package_env(), capture_output=True,
                              text=True, timeout=PHASE7_TIMEOUT)
        jobs.append(proc)
        return proc.returncode

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        folder = os.path.join(work, "data")
        os.makedirs(folder)
        t = time.perf_counter()
        mesh = mtt.synth.build_voronoi_mesh(n_cells, jitter=0.05,
                                            n_layers=n_layers)
        write_nc3_dataset(folder, mesh, [
            mtt.synth.solid_body_fields(mesh, n_layers=n_layers, omega=w)
            for w in (1e-5, 1.2e-5)])
        times["7d data"] = time.perf_counter() - t
        log(f"[phase 7d] agent and frontend on {dev}: {n_cells} cells, "
            f"L{n_layers}, 2 snapshots written as NetCDF-3 in "
            f"{times['7d data']:.3f} s")
        os.chdir(work)
        run_job, agent.run_job = agent.run_job, counted_job
        srv = serve(port=0, output_dir="agent_outputs", browse_root=work,
                    background=True)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/api/status",
                                        timeout=30) as r:
                status = json.loads(r.read())
            log(f"  GET /api/status: {status}")
            if status["device"] != f"cuda:{torch.cuda.get_device_name(0)}" \
                    or status["n_devices"] != torch.cuda.device_count():
                fail("/api/status does not name the card")
            for request, task in AGENT_REQUESTS:
                body = json.dumps({"request": request, "data_folder": folder,
                                   "dry_run": False}).encode()
                req = urllib.request.Request(
                    base + "/api/task", data=body,
                    headers={"Content-Type": "application/json"})
                t = time.perf_counter()
                with urllib.request.urlopen(
                        req, timeout=PHASE7_TIMEOUT + 30) as r:
                    data = json.loads(r.read())
                sec = time.perf_counter() - t
                proc = jobs[-1]
                launches = _worker_results([(proc.returncode, proc.stdout,
                                             proc.stderr)], task)[0][-1]
                done = [ln for ln in proc.stdout.splitlines()
                        if "done ->" in ln]
                log(f"  {task} ({request!r}): success {data['success']}, "
                    f"{sec:.3f} s for the job (process start included); "
                    f"launches in the job {launches}; {done} ({smi})")
                if not data["success"] or data["task"] != task:
                    fail(f"7d {task}: {data}")
                out[task] = {"seconds": sec, "launches": launches,
                             "config": data["config"]}
                times[f"7d {task} job"] = sec
        finally:
            srv.shutdown()
            srv.server_close()
            agent.run_job = run_job
            os.chdir(cwd)

        sub = lambda task, name: os.path.join(
            work, out[task]["config"]["output_subdir"], name)
        scfg = out["streamline"]["config"]
        n_rec = mtt.TrajectorySettings(
            delta_t=scfg["delta_minutes"] * 60,
            record_t=scfg["record_every_minutes"] * 60,
            simulation_duration=scfg["duration_days"] * mtt.ONE_DAY).n_records
        with open(sub("streamline", "streamline.vtp")) as f:
            found = re.search(r'NumberOfPoints="(\d+)" NumberOfLines="(\d+)"',
                              f.read(400))
        n_pts, n_lines = map(int, found.groups()) if found else (0, 0)
        pngs = [sub("remapping", f"remap_{c}.png")
                for c in ("east", "north", "speed")]
        have = {os.path.basename(p): os.path.getsize(p) for p in pngs
                if os.path.exists(p)}
        path_ok = os.path.getsize(sub("pathline", "pathline.vtp")) > 0
        log(f"  streamline VTP: {n_pts} points, {n_lines} lines (expected "
            f"{n_lines} x {n_rec + 1}); remap PNGs {have}; pathline VTP "
            f"written {path_ok}")
    steps = {"streamline": scfg["duration_days"] * 86400
             // (scfg["delta_minutes"] * 60),
             "pathline": 86400 // (out["pathline"]["config"]["delta_minutes"]
                                   * 60)}
    want = {"streamline": ("k3", steps["streamline"]),
            "pathline": ("k4", steps["pathline"]), "remapping": (None, 0)}
    for task, (key, k_steps) in want.items():
        expect = dict.fromkeys(sk.COUNT_KEYS, 0)
        if key:
            expect.update({key: k_steps, f"{key} repair": k_steps})
        if out[task]["launches"] != expect:
            fail(f"7d {task}: launches {out[task]['launches']}, expected "
                 f"{expect}")
    if n_lines == 0 or n_pts != n_lines * (n_rec + 1) or len(have) != 3 \
            or min(have.values()) == 0 or not path_ok:
        fail("7d: the jobs' outputs")
    return out


def vtp_counts(path):
    """(points, lines) that a VTP file's header declares."""
    with open(path) as f:
        head = f.read(400)
    found = re.search(r'NumberOfPoints="(\d+)" NumberOfLines="(\d+)"', head)
    return tuple(map(int, found.groups())) if found else (0, 0)


def pathline_month(dev, case, omegas, seeds, n_steps, n_layers, timed, smi,
                   rows, dtype=None):
    """Phase 8e: the reference tutorial's pathline (tutorial/pathLine.cpp)
    on ``case``'s mesh at ``n_layers`` (a bench_refscale.build case with
    meshes at f32 and f64; its own fields are not used): two snapshots at
    ``omegas`` (prof_dma.FIELD_KW, temperature and salinity) preprocessed on
    ``dev`` at f32 and f64, ``seeds`` at 10..500 m, RK4 at dt PATH_DT for
    ``n_steps`` steps, a record every PATH_RECORD (or one at the end of a
    shorter run), FailMode.ZERO, in ``dtype`` (default f32).

    First K2's generic instance and K4 one step against their plain
    versions on check_lanes of these seeds, cells and depths (f32 and f64,
    RK4 and Euler, two attributes, alphas mid-month and near 1).  Then the
    window path (the default: K4 and its repair, the generic masked
    K2) and the full column (K2's generic instance), each timed with every
    launch count set to 0 just before it; LAST_RESOLVED's instance and
    attributes; the clamp probe's rerun of the window path; the two paths'
    final positions within 100 m; attribute records non-zero; the gates
    (bench.gate at f32 and f64 on REFSCALE_GATE lanes spread evenly over
    the seeds: the grid's first rows all lie at the pole); the window
    path's repair time a step under torch.profiler over PROFILE_STEPS.
    Records K2's and K4's launches, K4's repairs and the repair's time in
    ``rows[key]["L80"]``.  Returns (summary, {"window": RawTrajectories,
    "full column": RawTrajectories})."""
    import numpy as np
    import torch

    import mops_tpu_torch as mtt
    from mops_tpu_torch import advect, bench, prof_dma
    from mops_tpu_torch.kernels import stage_kernel as sk
    f32, f64 = torch.float32, torch.float64
    real = dtype or f32
    n = len(seeds)
    L = n_layers
    meshes = case.meshes
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) / 1e9
    fronts, backs = {}, {}
    for om, dst, name in ((omegas[0], fronts, "front"),
                          (omegas[1], backs, "back")):
        raw = timed(f"8e synth {name} fields (omega {om:g})",
                    lambda: mtt.synth.solid_body_fields(
                        case.mesh, n_layers=L, omega=om,
                        **prof_dma.FIELD_KW))
        raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
        for r, tag in ((f32, "f32"), (f64, "f64")):
            dst[r] = timed(f"8e preprocess {name} {tag} (card)",
                           lambda: mtt.preprocess(meshes[r], raw, dtype=r,
                                                  device=dev))
        del raw
    peak_fields = torch.cuda.max_memory_allocated(dev) / 1e9
    cells = timed("8e cell search", lambda: mtt.CellSearch(case.mesh).query(
        seeds))
    depths = mtt.seeding.linear_depth_profile(n, 10, 500)
    cfg = mtt.TrajectorySettings(
        delta_t=PATH_DT, simulation_duration=PATH_DT * n_steps,
        record_t=min(PATH_RECORD, PATH_DT * n_steps), particle_depths=depths,
        fail_mode=mtt.FailMode.ZERO)
    log(f"  {n} seeds at 10..500 m, {int((cells >= 0).sum())} in a cell; "
        f"{n_steps} steps of {PATH_DT} s, {cfg.n_records} records; device "
        f"memory peak {peak_fields:.3f} GB with the fields at f32 and f64, "
        f"{peak_fields - base:.3f} GB above the {base:.3f} GB allocated "
        "before 8e")
    out = {"base_gb": base, "peak_gb_fields": peak_fields}
    # K2's generic instance and K4 (its repair the generic masked K2) one
    # step against their plain versions on these lanes, two attributes
    sols = {(name, r): d[r] for name, d in (("front", fronts),
                                            ("back", backs))
            for r in (f32, f64)}
    torch.cuda.reset_peak_memory_stats(dev)
    timed("8e kernel checks", lambda: check_kernels(
        meshes, sols, check_lanes(seeds, cells, depths,
                                  case.mesh.cells_on_cell.numpy()),
        L, smi, None, "8e's inputs", streamline=False, attr_counts=(2,)))
    out["peak_gb_checks"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  device memory peak over the kernel checks "
        f"{out['peak_gb_checks']:.3f} GB")
    del sols
    raws = {}
    for windowed, key, label in ((None, "k4", "window"),
                                 (False, "k2", "full column")):
        sk.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        raw = mtt.run_advection(meshes[real], fronts[real], seeds, cells, cfg,
                                back=backs[real], dtype=real, device=dev,
                                use_window=windowed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = sk.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        path = dict(advect.LAST_RESOLVED)
        want = {"k4": n_steps, "k4 repair": n_steps} if key == "k4" \
            else {"k2": n_steps}
        rate = n * n_steps / seconds
        rec = {"particle_rk4_steps_per_s": rate, "seconds": seconds,
               "peak_gb": peak, "launches": counts, "path": path}
        if key == "k4":
            rec["misses"] = miss_shares(raw, n_steps)
        log(f"  8e {label}: {rate:.6e} particle-RK4-steps/s ({seconds:.3f} "
            f"s), launches {counts}, instance {path['instance']}, "
            f"{path['n_attrs']} attributes, window {path['window']}; "
            + (miss_line(rec["misses"]) + "; " if key == "k4" else "")
            + f"peak device memory {peak:.3f} GB, {peak - base:.3f} GB "
            f"above the base ({smi})")
        if any(counts[k] != want.get(k, 0) for k in counts):
            fail(f"8e {label}: launch counts {counts}, expected {want}")
        if (path["instance"], path["n_attrs"], path["window"]) \
                != ("generic", 2, key == "k4"):
            fail(f"8e {label}: path {path}")
        rows[key]["L80"]["launches"] = counts[key]
        if key == "k4":
            rows["k2"]["L80"]["repair_launches"] = counts["k4 repair"]
        t = time.perf_counter()
        lines = mtt.finalize_trajectories(
            seeds, raw.points.cpu().numpy(), raw.velocities.cpu().numpy(),
            cfg, attrs=raw.attrs.cpu().numpy(), with_attrs=True)
        rec["finalize_s"] = time.perf_counter() - t
        if tuple(raw.points.shape) != (n, cfg.n_records, 3) \
                or raw.attrs is None or raw.attrs.shape != raw.points.shape \
                or len(lines) != n or lines[0].attrs is None:
            fail(f"8e {label}: output shapes")
        del lines
        final = raw.final_position.double()
        alive = raw.alive & torch.isfinite(final).all(dim=1)
        att = raw.attrs[alive][:, :, :2]
        nonzero = float((att != 0).all(dim=2).double().mean())
        disp = (final - torch.as_tensor(seeds, device=final.device)
                .double()).norm(dim=1)[alive]
        log(f"  finalize_trajectories {rec['finalize_s']:.3f} s; alive and "
            f"finite {int(alive.sum())}/{n}; median displacement "
            f"{float(disp.median()):.1f} m; attribute records finite "
            f"{bool(torch.isfinite(att).all())}, non-zero on alive lanes "
            f"{100 * nonzero:.3f}%")
        if not bool(torch.isfinite(att).all()) or nonzero < ATTR_NONZERO:
            fail(f"8e {label}: attributes are not finite and non-zero")
        if not float(disp.median()) > 0.0:
            fail(f"8e {label}: particles did not move")
        rec["attr_nonzero"] = nonzero
        out[f"8e {label}"] = rec
        raws[label] = raw
        del att, final
    err = (raws["window"].final_position.double()
           - raws["full column"].final_position.double()).norm(dim=1)
    share = float((err <= 100.0).double().mean())
    log(f"  window vs full column: {100 * share:.3f}% of final positions "
        f"within 100 m, median difference {float(err.median()):.3e} m")
    if share < bench.GATE_SHARE[f32]:
        fail("8e: the window path left the full-column path")
    out["window_vs_full_within_100m"] = share
    with ClampProbe() as probe:
        again = timed("8e window path, clamp probe", lambda: mtt.run_advection(
            meshes[real], fronts[real], seeds, cells, cfg, back=backs[real],
            dtype=real, device=dev))
    same = torch.equal(again.final_position, raws["window"].final_position)
    clamp = out["8e window"]["misses"]["clamp"]
    log(f"  the clamp probe's run: {probe.flagged} lane-steps flagged by the "
        f"clamp test alone (the timed run counted {clamp}), on "
        f"{probe.differed} of them the window step alone would have parted "
        f"from the full step; final positions bit-equal to the timed run's: "
        f"{same}")
    if not same or probe.flagged != clamp:
        fail("8e: the clamp probe's run")
    out["clamp probe"] = {"flagged": probe.flagged, "parted": probe.differed}
    del again
    # the gates on lanes spread over the grid
    idx = np.linspace(0, n - 1, min(REFSCALE_GATE, n)).astype(np.int64)
    gcfg = dataclasses.replace(cfg, particle_depths=depths[idx])
    torch.cuda.reset_peak_memory_stats(dev)
    for r, tag in ((f32, "f32"), (f64, "f64")):
        for windowed, label in ((None, "window"), (False, "full column")):
            g = bench.gate(meshes[r], fronts[r], seeds[idx], cells[idx], gcfg,
                           back=backs[r], dtype=r, device=dev,
                           use_window=windowed)
            log(f"  8e gate {tag} {label}: "
                + bench.gate_line(g).lstrip("# ") + f" ({smi})")
            if not g["verified"] or g["attr_share"] is None \
                    or g["path"]["instance"] != "generic":
                fail(f"8e gate {tag} {label}")
            out[f"gate {tag} {label}"] = {
                k: g[k] for k in ("share", "attr_share", "off", "tie_flips",
                                  "verified")}
    out["peak_gb_gates"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  device memory peak over the gates {out['peak_gb_gates']:.3f} GB")
    # the window path's repair (the generic masked K2), its device time a
    # step apart from K4's under torch.profiler after a warm-up
    prof_cfg = dataclasses.replace(
        cfg, simulation_duration=PATH_DT * PROFILE_STEPS,
        record_t=PATH_DT * 3)
    for r, tag, ctype in ((f32, "f32", "float"), (f64, "f64", "double")):
        def run():
            return mtt.run_advection(meshes[r], fronts[r], seeds, cells,
                                     prof_cfg, back=backs[r], dtype=r,
                                     device=dev)
        shares = miss_shares(run(), PROFILE_STEPS)
        busy, window, per_name, _ = device_breakdown(run)
        repair = f"pathline_step_kernel<{ctype}, {sk.L_MAX}, true>"
        r_ms = sum(ms for nm, ms in per_name.items() if repair in nm)
        k_ms = sum(ms for nm, ms in per_name.items()
                   if "window_pathline_kernel" in nm)
        log(f"  {tag} window path at L{L} under torch.profiler: device busy "
            f"{busy:.3f} ms of a {window:.3f} ms window, idle share "
            f"{100 * (1 - busy / window):.2f}%, K4 {k_ms:.3f} ms, masked "
            f"repair {repair} {r_ms:.3f} ms, "
            f"{1e3 * r_ms / PROFILE_STEPS:.2f} us a step; "
            f"{miss_line(shares)} ({smi})")
        if r_ms <= 0.0 or k_ms <= 0.0:
            fail(f"8e profile {tag}: no K4 or no generic repair on the device")
        rows["k2"]["L80"].setdefault("repair_ms_per_step", {})[tag] = \
            r_ms / PROFILE_STEPS
        out[f"profile {tag}"] = {"busy_ms": busy, "window_ms": window,
                                 "k4_ms": k_ms, "repair_ms": r_ms,
                                 "misses": shares}
    return out, raws


def reference_scale(dev, rows, ptxas, timed, times, smi):
    """Phase 8: the 80-layer path, the generic (L > 64) instances of K1 and
    K2 on case A's mesh, then the BASELINE configs and the tutorials.
    Records each kernel's L80 row in ``rows[key]["L80"]``; returns the
    phase's summary."""
    import numpy as np
    import torch

    import mops_tpu_torch as mtt
    from mops_tpu_torch import bench, prof_dma
    from mops_tpu_torch.kernels import stage_kernel as sk
    from mops_tpu_torch.scripts import baseline_configs as bc
    from mops_tpu_torch.scripts import bench_refscale as rs
    from mops_tpu_torch.tutorials import (pathline, regrid, remapping,
                                          streamline)
    f32, f64 = torch.float32, torch.float64
    n_cells, L, n = REFSCALE
    t_phase8 = time.perf_counter()
    out = {}

    # ---- 8a: the kernel checks at L80 -------------------------------------
    log(f"[phase 8a] case A's mesh ({n_cells} cells, L{L}, {n} seeds, "
        f"crossing regime): K1-K4 vs their plain versions at L{L}")
    case = timed("8 build case A (host mesh, card fields, cell search)",
                 lambda: rs.build(n_cells, L, n, with_attrs=True,
                                  crossing=True, device=dev,
                                  dtypes=(f32, f64)))
    raw_b = timed("8 synth back fields", lambda: mtt.synth.solid_body_fields(
        case.mesh, n_layers=L, omega=1.2e-5, **bench.CROSSING))
    raw_b = {k: np.asarray(v, np.float32) for k, v in raw_b.items()}
    meshes = case.meshes
    sols = {}
    for real in (f32, f64):
        sols["stream", real] = sols["front", real] = case.sols[real]
        sols["back", real] = mtt.preprocess(meshes[real], raw_b, dtype=real,
                                            device=dev)
    del raw_b
    K = case.mesh.max_edges
    if K > sk.K_MAX or sk.column_instance(L) != "generic":
        fail(f"case A's K={K}, L={L} do not take the generic instances")
    depths = mtt.seeding.linear_depth_profile(n, 10, 500)
    for key, kname in (("k1", "streamline_step_kernel"),
                       ("k2", "pathline_step_kernel"),
                       ("k3", "streamline_step_kernel"),
                       ("k4", "pathline_step_kernel")):
        generic = {label: rep for label, rep in ptxas.items()
                   if label.split()[0] == kname
                   and label.split()[2] == str(sk.L_MAX)}
        rows[key]["L80"] = {"ptxas_generic": generic}
        for label, rep in sorted(generic.items()):
            log(f"  {key.upper()}{' repair' if key in ('k3', 'k4') else ''}"
                f" generic instance, ptxas {label}: {rep['registers']} "
                f"registers, {rep['spill_stores']} B of spill stores, "
                f"{rep['spill_loads']} B of spill loads")
    for key, entry in (("k1", "streamline"), ("k2", "pathline")):
        rows[key]["L80"]["layout"] = {}
        for real, tag in ((f32, "f32"), (f64, "f64")):
            slot, per_block = sk.layout(entry, K, L, real)
            rows[key]["L80"]["layout"][tag] = {
                "smem_per_particle": slot, "particles_per_block": per_block}
            log(f"  {key.upper()} {tag} at K={K}, L={L}: {slot} B of shared "
                f"memory a particle, {per_block} particles a block")
    t = time.perf_counter()
    check_kernels(
        meshes, sols,
        check_lanes(case.seeds, case.cells, depths,
                    case.mesh.cells_on_cell.numpy()), L, smi,
        lambda key, real: rows[key]["L80"].setdefault(
            "f32" if real == f32 else "f64", {}),
        f"L{L}", {"mid": (PATH_STEPS // 2) / PATH_STEPS})
    times["8a kernel checks"] = time.perf_counter() - t
    # the bounds at the start inputs: 8b's (100 m) for K1/K3, 8a's lanes'
    # for K2/K4 (two attributes)
    for key, pathline_, n_attrs, n_window in (
            ("k1", False, 0, None), ("k2", True, 2, None),
            ("k3", False, 0, WINDOW), ("k4", True, 2, WINDOW)):
        names = ["front", "back"] if pathline_ else ["stream"]
        d = depths if pathline_ else np.full(n, 100.0, np.float32)
        for real, tag in ((f32, "f32"), (f64, "f64")):
            b_ms, b_by, nbytes, ops = step_bound(
                meshes[real], [sols[k, real] for k in names], case.seeds,
                case.cells, d, n_attrs, tag, n_window)
            row = rows[key]["L80"][tag]
            row.update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
            log(f"  {key} {tag} at L{L}: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{nbytes / 1e6:.3f} MB, {ops / 1e9:.3f} G operations a "
                f"step) ({smi})")
    for real in (f32, f64):
        del sols["back", real]

    # ---- 8b: case A through bench_refscale --------------------------------
    log(f"[phase 8b] bench_refscale case A: {REFSCALE_STEPS} steps at dt "
        f"120 s and 100 m, the window path and the full column, f32; gates "
        f"on {REFSCALE_GATE} lanes at f32 and f64")
    cfg = rs.streamline_settings(REFSCALE_STEPS)
    finals = {}
    for windowed, key in ((True, "k3"), (False, "k1")):
        label = "window" if windowed else "full column"
        t = time.perf_counter()
        rec, raw = rs.case_A(case=case, n_steps=REFSCALE_STEPS, device=dev,
                             dtype=f32, use_window=windowed,
                             n_gate=REFSCALE_GATE)
        times[f"8b case A {label}"] = time.perf_counter() - t
        g64 = bench.gate(meshes[f64], case.sols[f64], case.seeds, case.cells,
                         cfg, dtype=f64, device=dev, n_gate=REFSCALE_GATE,
                         use_window=windowed)
        log("  " + bench.gate_line(g64).lstrip("# ") + " (f64)")
        launches = rec["launches"]
        want = {"k3": REFSCALE_STEPS, "k3 repair": REFSCALE_STEPS} \
            if windowed else {"k1": REFSCALE_STEPS}
        bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
        # K1 at L80 launches its generic instance (column_instance, checked
        # above): the repairs on the window path, every step on the full
        generic = launches["k3 repair"] + launches["k1"]
        edge = rec["window_misses"] - rec["window_clamp_misses"]
        log(f"  case A {label}: {rec['steps_per_s']:.6e} particle-RK4-"
            f"steps/s ({rec['elapsed_s']} s), window misses: edge {edge} "
            f"({100 * edge / (n * REFSCALE_STEPS):.4f}% of particle-steps), "
            f"clamp {rec['window_clamp_misses']} ("
            f"{100 * rec['window_clamp_misses'] / (n * REFSCALE_STEPS):.4f}"
            f"%), peak device memory {rec['peak_gb']:.3f} GB, "
            f"launches {launches} ({generic} of the generic K1), instance "
            f"{rec['path']['instance']}, step "
            f"{rec['path']['step_bytes'] / 1e6:.3f} MB; f32 gate share "
            f"{rec['gate']['share']:.6f} (tie flips "
            f"{rec['gate']['tie_flips']} of {rec['gate']['off']} off), f64 "
            f"{g64['share']:.6f} ({smi})")
        if not rec["verified"] or not g64["verified"]:
            fail(f"8b case A {label}: gate")
        if rec["path"]["instance"] != "generic" \
                or g64["path"]["instance"] != "generic":
            fail(f"8b case A {label}: not the generic instance")
        if bad:
            fail(f"8b case A {label}: launch counts {launches}, expected "
                 f"{want}")
        rows[key]["L80"]["launches"] = launches[key]
        if windowed:
            rows["k1"]["L80"]["repair_launches"] = launches["k3 repair"]
        out[f"8b {label}"] = {**rec, "gate_f64": {
            k: g64[k] for k in ("share", "off", "tie_flips", "verified")}}
        finals[key] = raw.final_position.double()
        del raw
    err = (finals["k3"] - finals["k1"]).norm(dim=1)
    share = float((err <= 100.0).double().mean())
    log(f"  window vs full column: {100 * share:.3f}% of final positions "
        f"within 100 m, median difference {float(err.median()):.3e} m")
    if share < bench.GATE_SHARE[f32]:
        fail("8b: the window path left the full-column path")
    out["8b window_vs_full_within_100m"] = share
    with ClampProbe() as probe:
        again = timed("8b window path, clamp probe", lambda: mtt.run_advection(
            meshes[f32], case.sols[f32], case.seeds, case.cells, cfg,
            dtype=f32, device=dev, use_window=True, graph=False))
    same = torch.equal(again.final_position.double(), finals["k3"])
    clamp = out["8b window"]["window_clamp_misses"]
    log(f"  the clamp probe's run: {probe.flagged} lane-steps flagged by the "
        f"clamp test alone (the timed run counted {clamp}), on "
        f"{probe.differed} of them the window step alone would have parted "
        f"from the full step; final positions bit-equal to the timed run's: "
        f"{same}")
    if probe.flagged != clamp or not same:
        fail("8b: the clamp probe's run")
    del again
    out["8b clamp probe"] = {"flagged": probe.flagged,
                             "parted": probe.differed}
    # the window path's masked K1 repair at L80 (the generic masked
    # instance, which spills at f64), its device time a step apart from
    # K3's under torch.profiler over PROFILE_STEPS steps after a warm-up
    pcfg = rs.streamline_settings(PROFILE_STEPS)
    for real, tag, ctype in ((f32, "f32", "float"), (f64, "f64", "double")):
        def run():
            return mtt.run_advection(meshes[real], case.sols[real],
                                     case.seeds, case.cells, pcfg,
                                     dtype=real, device=dev, use_window=True)
        shares = miss_shares(run(), PROFILE_STEPS)
        busy, window, per_name, _ = device_breakdown(run)
        repair = f"streamline_step_kernel<{ctype}, {sk.L_MAX}, true>"
        r_ms = sum(ms for nm, ms in per_name.items() if repair in nm)
        k_ms = sum(ms for nm, ms in per_name.items()
                   if "window_streamline_kernel" in nm)
        log(f"  {tag} window path at L{L} under torch.profiler: device busy "
            f"{busy:.3f} ms of a {window:.3f} ms window, K3 {k_ms:.3f} ms, "
            f"masked repair {repair} {r_ms:.3f} ms, "
            f"{1e3 * r_ms / PROFILE_STEPS:.2f} us a step; "
            f"{miss_line(shares)} ({smi})")
        if r_ms <= 0.0 or k_ms <= 0.0:
            fail(f"8b profile {tag}: no K3 or no generic repair on the device")
        rows["k1"]["L80"].setdefault("repair_ms_per_step", {})[tag] = \
            r_ms / PROFILE_STEPS
        out[f"8b profile {tag} misses"] = shares
    del finals

    # ---- 8e: the pathline month at L80 -------------------------------------
    log(f"[phase 8e] the pathline tutorial's month at L{L} on case A's mesh: "
        f"{PATH_STEPS} steps at dt {PATH_DT} s, the window path and the full "
        f"column, f32; gates on {REFSCALE_GATE} lanes at f32 and f64")
    sols.clear()                 # 8a's and 8b's crossing-regime fields
    case.sols.clear()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["8e"], month = pathline_month(
        dev, case, (prof_dma.PATH_OMEGA, prof_dma.BACK_OMEGA),
        prof_dma.slice_seeds(), PATH_STEPS, L, timed, smi, rows)
    times["8e pathline month"] = time.perf_counter() - t
    del case, meshes, month
    torch.cuda.empty_cache()

    # ---- 8c: the BASELINE configs -----------------------------------------
    log("[phase 8c] baseline_configs 1-4 at full size (config 5 is 6e)")
    for c in (1, 2, 3, 4):
        rec, res = timed(f"8c config {c}", lambda: bc.CONFIGS[c](False, dev))
        if c == 3:
            ok = len(res) >= 1 and res[0].shape == (601, 1201, 3) \
                and rec["finite_frac"] > 0
        else:
            r = res.double().norm(dim=1)
            ok = bool(torch.isfinite(res).all()) and bool(
                ((r - mtt.EARTH_RADIUS).abs() < 1e4).all()) \
                and len(res) == rec["particles"]
        log(f"  config {c}: {json.dumps(rec)}; outputs finite and on the "
            f"sphere: {ok} ({smi})")
        if not ok:
            fail(f"8c config {c}: outputs")
        out[f"8c config {c}"] = rec
        del res

    # ---- 8d: the tutorials --------------------------------------------------
    log("[phase 8d] the four tutorials at their defaults on the card")
    with tempfile.TemporaryDirectory() as tmp:
        j = lambda name: os.path.join(tmp, name)
        for name, mod, args in (
                ("streamline", streamline, ["--out", j("streamline.vtp")]),
                ("pathline", pathline, ["--out", j("pathline.vtp")]),
                ("remapping", remapping, ["--out", j("remap")]),
                ("regrid", regrid, ["--out", j("regrid")])):
            timed(f"8d tutorial {name}",
                  lambda: mod.main(args + ["--device", dev.type]))
        names = ("streamline.vtp", "pathline.vtp", "pathline.bin",
                 "remap_east.png", "remap_north.png", "remap_speed.png",
                 "remap.vti", "regrid_east.png", "regrid_north.png")
        sizes = {nm: os.path.getsize(j(nm)) for nm in names
                 if os.path.exists(j(nm))}
        n_pts, n_lines = vtp_counts(j("streamline.vtp"))
    n_rec = mtt.TrajectorySettings(delta_t=60, record_t=360,
                                   simulation_duration=5 * 86400).n_records
    n_seeds = len(mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(8, 8), lat_range=(20, 50), lon_range=(-80, -50))))
    log(f"  files {sizes}; streamline VTP {n_pts} points, {n_lines} lines "
        f"(expected {n_seeds} x {n_rec + 1} = {n_seeds * (n_rec + 1)})")
    if len(sizes) != len(names) or min(sizes.values()) == 0 \
            or n_lines != n_seeds or n_pts != n_lines * (n_rec + 1):
        fail("8d tutorial outputs")
    out["8d"] = {name: times[f"8d tutorial {name}"]
                 for name in ("streamline", "pathline", "remapping",
                              "regrid")}
    times["phase 8"] = time.perf_counter() - t_phase8
    log(f"  phase 8: {times['phase 8']:.3f} s (budget {PHASE8_BUDGET} s)")
    out["seconds"] = times["phase 8"]
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    import numpy as np

    import mops_tpu_torch as mtt
    from mops_tpu_torch import advect, prof_dma
    from mops_tpu_torch.interp import wachspress_weights
    from mops_tpu_torch.kernels import nvcc_build
    from mops_tpu_torch.kernels import row_gather as rg
    from mops_tpu_torch.bench import ATTR_REL_TOL, GATE_SHARE, gate_check
    from mops_tpu_torch.kernels import stage_kernel as sk
    from mops_tpu_torch.prof_dma import BACK_OMEGA, FIELD_KW, PATH_OMEGA, \
        SLICE_LAYERS, event_ms
    from mops_tpu_torch.step import (_clamp_profile, _layer_search_binary,
                                     _layer_search_linear)

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    sync = torch.cuda.synchronize
    kernels = {
        "k1": sk.fused_streamline_step, "k2": sk.fused_pathline_step,
        "k3": sk.fused_window_streamline_step,
        "k4": sk.fused_window_pathline_step, "k5": rg.row_gather_probe}

    def launches():
        """K1-K5's launch counts (stage_kernel.launch_counts without the
        window kernels' repairs, and K5's)."""
        counts = sk.launch_counts()
        return {**{k: counts[k] for k in ("k1", "k2", "k3", "k4")},
                "k5": rg.row_gather_probe.launches}

    def reset_counts():
        sk.reset_counts()
        rg.row_gather_probe.launches = 0

    # ---- phase 0: set-up --------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind} (count {torch.cuda.device_count()})")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn tf32 {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        built = [pool.submit(mod.build) for mod in (sk, rg)]
        lib_paths = [f.result() for f in built]
    build_s = time.perf_counter() - t0
    log(f"[phase 0] kernel build {build_s:.2f} s -> "
        f"{', '.join(map(str, lib_paths))}")
    log(sk.BUILD_LOG.strip())
    log(rg.BUILD_LOG.strip())
    ptxas = nvcc_build.ptxas_report(sk.BUILD_LOG + rg.BUILD_LOG)
    for label, rep in sorted(ptxas.items()):
        log(f"  ptxas {label}: {rep}")
    if not ptxas:
        fail("no ptxas report in the build log")

    times = {}

    def timed(name, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        times[name] = time.perf_counter() - t
        log(f"  {name}: {times[name]:.3f} s")
        return out

    # ---- the slice's inputs (host mesh, device fields) -------------------
    L = SLICE_LAYERS
    mesh_h = timed("synth mesh", prof_dma.slice_mesh)
    field_kw = dict(n_layers=L, **FIELD_KW)
    raws = {
        "stream": timed("synth fields", lambda: mtt.synth.solid_body_fields(
            mesh_h, **field_kw)),
        "front": timed("synth pathline front fields",
                       lambda: mtt.synth.solid_body_fields(
                           mesh_h, omega=PATH_OMEGA, **field_kw)),
        "back": timed("synth pathline back fields",
                      lambda: mtt.synth.solid_body_fields(
                          mesh_h, omega=BACK_OMEGA, **field_kw))}
    meshes = {f32: mesh_h.to(dev, f32), f64: mesh_h.to(dev, f64)}
    sols = {}
    for real, tag in ((f32, "f32"), (f64, "f64")):
        for key, raw in raws.items():
            sols[key, real] = timed(
                f"preprocess {key} {tag} (card)",
                lambda: mtt.preprocess(meshes[real], raw, dtype=real))
    seeds = prof_dma.slice_seeds()
    n = len(seeds)
    cells = timed("cell search", lambda: mtt.CellSearch(mesh_h).query(seeds))
    depths = mtt.seeding.linear_depth_profile(n, 10, 500)
    K = mesh_h.max_edges
    log(f"slice: {mesh_h.n_cells} cells, {mesh_h.n_vertices} vertices, "
        f"K={K}, L={L}, {n} particles, {N_STEPS} streamline steps, "
        f"{PATH_STEPS} pathline steps")
    if K > sk.K_MAX:
        fail(f"mesh maxEdges {K} above the kernel ceiling")

    # ---- phase 1: every kernel vs its plain version ----------------------
    log("[phase 1] kernel checks at the slice shape")
    rows = {k: {} for k in kernels}
    kernel_names = {"k1": "streamline_step_kernel",
                    "k2": "pathline_step_kernel",
                    "k3": "window_streamline_kernel",
                    "k4": "window_pathline_kernel", "k5": "row_gather_kernel"}
    for key, kname in kernel_names.items():
        rows[key]["ptxas"] = {label: rep for label, rep in ptxas.items()
                              if label.split()[0] == kname}
        if not rows[key]["ptxas"]:
            fail(f"no ptxas report for {kname}")
    # K1's and K2's plain instances hold their register caps without
    # spilling: the main path's (L <= 64) at both dtypes, the generic one
    # (L <= L_MAX, 8b's L80 path) at float32
    spilled = [label for key in ("k1", "k2")
               for label, rep in rows[key]["ptxas"].items()
               if (label.endswith(f" {sk.COLUMN_LT} 0")
                   or label.endswith(f" f32 {sk.L_MAX} 0"))
               and rep["spill_stores"]]
    if spilled:
        fail(f"ptxas spill stores in {spilled}")
    for key, entry in (("k1", "streamline"), ("k2", "pathline")):
        rows[key]["layout"] = {}
        for real, tag in ((f32, "f32"), (f64, "f64")):
            slot, per_block = sk.layout(entry, K, L, real)
            rows[key]["layout"][tag] = {"smem_per_particle": slot,
                                        "particles_per_block": per_block}
            log(f"  {key.upper()} {tag} at K={K}, L={L}: {slot} B of shared "
                f"memory a particle, {per_block} particles a block")
    check_kernels(meshes, sols, check_lanes(
        seeds, cells, depths, mesh_h.cells_on_cell.numpy()), L, smi,
        lambda key, real: rows[key] if real == f32 else None,
        "the slice shape")
    log("[phase 1b] the window kernels on rising columns: the crossing case "
        f"of {RISING_CASE[0]} cells and {RISING_CASE[1]} seeds at "
        f"L{RISING_LAYERS}")
    rising = rising_columns(dev, smi, timed)

    # ---- phase 1c: the row-gather probe (K5) ----------------------------
    log("[phase 1c] row-gather probe K5: its main path (python -m "
        "mops_tpu_torch.prof_dma) at (a) prof_dma.py's shape, then kernel "
        "vs plain vs index_select at (a), (b) the streamline table and (c) "
        "the pathline front table")
    reset_counts()
    probe, tab_a, ids_a = timed("prof_dma main path",
                                lambda: prof_dma.main([]))
    counts = launches()
    rows["k5"]["launches"] = counts["k5"]
    if counts["k5"] == 0 or sum(counts.values()) != counts["k5"]:
        fail(f"launch counts of the probe's main path: {counts}")
    vids_m, nv_m, _ = advect._gather_cell_vertices(
        meshes[f32], torch.as_tensor(cells, device=dev).clamp(min=0))
    k5_rows = {}

    def k5_case(label, tab, ids, dropped=0, res=None, timed_case=True):
        """Hold K5 against its plain version; on the timed case, time the
        kernel (unless ``res`` holds the main path's measurement of these
        inputs), the plain version and index_select."""
        head, sums = rg.row_gather_probe(tab, ids)
        sync()
        want_head, want_sums = rg.row_gather_plain(tab, ids)
        scale = rg.row_gather_plain(tab.abs(), ids)[1]
        sync()
        err = float((sums - want_sums).abs().max())
        rel = float(((sums - want_sums).abs() / scale).max())
        mb = tab.numel() * tab.element_size() / 1e6
        log(f"  K5 {label}: {ids.numel()} ids ({dropped} dropped to a "
            f"multiple of {rg.BLOCK_ROWS}), rows of {tab.shape[1]} x "
            f"{tab.element_size()} B from a {mb:.1f} MB table; head bit-equal "
            f"{torch.equal(head, want_head)}; block sums max |d| {err:.3e}, "
            f"max |d| / sum|x| {rel:.3e} (tol {K5_SUM_TOL:.0e})")
        if not torch.equal(head, want_head) or not rel <= K5_SUM_TOL:
            fail(f"kernel check k5 {label}")
        if not timed_case:
            return
        res = res or prof_dma.measure(tab, ids)
        plain_ms = event_ms(lambda: rg.row_gather_plain(tab, ids), 3)
        lib_ms = event_ms(lambda: torch.index_select(tab, 0, ids), 20)
        log(f"  K5 {label}: kernel {res['ms']:.4f} ms "
            f"({res['gb_per_s']:.1f} GB/s of {res['gathered_bytes'] / 1e6:.1f}"
            f" MB gathered), plain {plain_ms:.3f} ms, index_select "
            f"{lib_ms:.4f} ms; bound {res['bound_ms']:.4f} ms "
            f"({res['unique_rows']} unique rows, "
            f"{res['bound_bytes'] / 1e6:.1f} MB), gathered bytes over the "
            f"memory rate {res['gathered_bound_ms']:.4f} ms ({smi})")
        # one code path at every row length: 16-B loads into registers
        k5_rows[label] = {**res, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "max_abs_err": err, "dropped_ids": dropped,
                          "path": "16-B loads into registers"}

    k5_case("(a) prof_dma", tab_a, ids_a, res=probe)
    k5_case("(a) prof_dma f64", tab_a.double(), ids_a, timed_case=False)
    del tab_a
    for label, tab in (
            ("(b) streamline", packed(meshes[f32], sols["stream", f32])),
            ("(c) pathline front", packed(meshes[f32], sols["front", f32],
                                          2))):
        ids_s, dropped = prof_dma.vertex_slot_ids(vids_m, nv_m)
        k5_case(label, tab, ids_s, dropped)
        del tab
    a_row = k5_rows["(a) prof_dma"]
    rows["k5"].update(
        max_abs_err=a_row["max_abs_err"], ms=a_row["ms"],
        plain_ms=a_row["plain_ms"], bound_ms=a_row["bound_ms"],
        bound_by="bytes", library_ms=a_row["library_ms"], shapes=k5_rows)
    del ids_a, vids_m, nv_m

    # ---- phase 2: the main paths -----------------------------------------
    mesh32 = meshes[f32]

    def layers_at(pos, depth, cell, sol, pathline=False):
        vids, nv, _ = advect._gather_cell_vertices(mesh32, cell)
        w = wachspress_weights(pos.to(f32), mesh32.vertex_xyz[vids.long()], nv)
        z = torch.einsum("nk,nkl->nl", w, sol.vertex_ztop[vids.long()])
        z, d = _clamp_profile(z, True), (-depth).to(f32)
        return _layer_search_linear(z, d)[0] if pathline \
            else _layer_search_binary(z, d)

    seeds_d = torch.as_tensor(seeds, device=dev)
    cells_d = torch.as_tensor(cells, device=dev)
    depths_d = torch.as_tensor(depths, device=dev)
    cfg = mtt.TrajectorySettings(
        delta_t=120, simulation_duration=120 * N_STEPS, record_t=360,
        particle_depths=depths, fail_mode=mtt.FailMode.ZERO)
    pcfg = mtt.TrajectorySettings(
        delta_t=PATH_DT, simulation_duration=PATH_DT * PATH_STEPS,
        record_t=PATH_RECORD, particle_depths=depths,
        fail_mode=mtt.FailMode.ZERO)
    summary = {}
    finals = {}
    refs = {}
    last_points = {}
    for label, key, pathline, windowed in (
            ("2a streamline, layer window", "k3", False, True),
            ("2b streamline, full column", "k1", False, False),
            ("2c pathline, layer window", "k4", True, True),
            ("2d pathline, full column", "k2", True, False)):
        log(f"[phase {label}] main path (f32, {key.upper()})")
        run_cfg = pcfg if pathline else cfg
        front = sols["front" if pathline else "stream", f32]
        back = sols["back", f32] if pathline else None
        reset_counts()
        raw_traj = timed(f"run_advection {label}", lambda: mtt.run_advection(
            mesh32, front, seeds, cells, run_cfg, back=back,
            use_window=windowed))
        counts = launches()
        repairs = sk.launch_counts()[f"{key} repair"] if windowed else 0
        rate = n * run_cfg.n_steps / times[f"run_advection {label}"]
        misses = 0 if raw_traj.window_misses is None \
            else int(raw_traj.window_misses.sum())
        log(f"  launches {counts}, repair launches {repairs} for "
            f"{run_cfg.n_steps} steps; {rate:.6e} "
            f"particle-RK4-steps/s end to end; window misses {misses} "
            f"({100 * misses / (n * run_cfg.n_steps):.4f}% of particle-steps)"
            f" ({smi})")
        if windowed:
            shares = miss_shares(raw_traj, run_cfg.n_steps)
            with ClampProbe() as probe:
                again = timed(f"run_advection {label}, clamp probe",
                              lambda: mtt.run_advection(
                                  mesh32, front, seeds, cells, run_cfg,
                                  back=back, use_window=True, graph=False))
            shares.update(probe_flagged=probe.flagged,
                          parted=probe.differed)
            same = torch.equal(again.final_position, raw_traj.final_position)
            log(f"  {miss_line(shares)}; the clamp probe's run: "
                f"{probe.flagged} lane-steps flagged by the clamp test alone, "
                f"on {probe.differed} of them the window step alone would "
                f"have parted from the full step; final positions bit-equal "
                f"to the timed run's: {same} (repair time a step: phase 4)")
            if not same or probe.flagged != shares["clamp"]:
                fail(f"{label}: the clamp probe's run")
            del again
        if not pathline:
            again, census = kernel_census(lambda: mtt.run_advection(
                mesh32, front, seeds, cells, run_cfg, use_window=windowed))
            faults = census_faults(census, key, run_cfg.n_steps)
            same = all(torch.equal(getattr(again, f), getattr(raw_traj, f))
                       for f in ("points", "velocities", "final_position"))
            log(f"  the same run under torch.profiler: {census_line(census)}"
                f"; points, velocities and final positions bit-equal to the "
                f"timed run's: {same}")
            if faults or not same:
                fail(f"{label}: the traced run: {faults}, bit-equal {same}")
            del again
        if counts[key] != run_cfg.n_steps or sum(counts.values()) \
                != counts[key] or (windowed and repairs != run_cfg.n_steps):
            fail(f"launch counts {counts}, repairs {repairs}: {key} != "
                 f"{run_cfg.n_steps} steps")
        if (raw_traj.window_misses is None) == windowed:
            fail("window miss counts")
        rows[key]["launches"] = counts[key]
        if windowed:
            rows[key]["repair_launches"] = repairs
        summary[key] = {"particle_rk4_steps_per_s": rate,
                        "window_misses": misses}
        if windowed:
            summary[key]["misses"] = shares
        if not pathline:
            summary[key]["census"] = census
        attrs = raw_traj.attrs.cpu().numpy() if pathline else None
        lines = timed(f"finalize_trajectories {label}",
                      lambda: mtt.finalize_trajectories(
                          seeds, raw_traj.points.cpu().numpy(),
                          raw_traj.velocities.cpu().numpy(), run_cfg,
                          attrs=attrs, with_attrs=pathline))
        final = raw_traj.final_position.double()
        if tuple(raw_traj.points.shape) != (n, run_cfg.n_records, 3) \
                or len(lines) != n \
                or (raw_traj.attrs is not None) != pathline \
                or (pathline and (raw_traj.attrs.shape
                                  != raw_traj.points.shape
                                  or lines[0].attrs is None)):
            fail("output shapes")
        alive = raw_traj.alive & torch.isfinite(final).all(dim=1)
        radius = final[alive].norm(dim=1)
        disp = (final - seeds_d).norm(dim=1)[alive]
        layer0 = layers_at(seeds_d, depths_d, cells_d, front, pathline)
        layer1 = layers_at(raw_traj.final_position, raw_traj.final_depth,
                           raw_traj.final_cell, front, pathline)
        changed = int(((layer0 != layer1) & alive).sum())
        log(f"  alive and finite {int(alive.sum())}/{n}; radius "
            f"[{float(radius.min()):.1f}, {float(radius.max()):.1f}] m; "
            f"median displacement {float(disp.median()):.1f} m; lanes that "
            f"changed layer {changed}")
        if not bool((radius - mtt.EARTH_RADIUS).abs().max() < 1e4):
            fail("final radii are not about 6.371e6 m")
        if not float(disp.median()) > 0.0:
            fail("particles did not move")
        if changed == 0:
            fail("no particle changed layer")
        if pathline:
            att = raw_traj.attrs[alive][:, :, :2]
            nonzero = float((att != 0).all(dim=2).double().mean())
            log(f"  attribute records finite: "
                f"{bool(torch.isfinite(att).all())}, non-zero on alive "
                f"lanes: {100 * nonzero:.3f}%; last record mean "
                f"temperature {float(att[:, -1, 1].mean()):.4f}, salinity "
                f"{float(att[:, -1, 0].mean()):.4f}")
            if not bool(torch.isfinite(att).all()) or nonzero < ATTR_NONZERO:
                fail("pathline attributes are not finite and non-zero")
            summary[key]["attr_nonzero"] = nonzero
            del att
        finals[key] = final.cpu().numpy()
        last_points[key] = np.stack([line.last_point for line in lines])
        if key != "k2":
            refs[key] = raw_traj         # phase 6's references
        del raw_traj, lines
    for a, b in (("k3", "k1"), ("k4", "k2")):
        err = np.linalg.norm(finals[a] - finals[b], axis=1)
        frac = float((err <= 100.0).mean())
        log(f"  {a} path vs {b} path: {100 * frac:.3f}% of final positions "
            f"within 100 m, median difference {float(np.median(err)):.3e} m")
        if frac < GATE_SHARE[f32]:
            fail(f"the window path {a} left the full-column path {b}")
        summary[a][f"final_within_100m_of_{b}"] = frac

    # ---- phase 3: gate, kernel paths vs plain path ------------------------
    log("[phase 3] gate: 20 steps, both kernel paths vs the plain path")
    gate_cfg = mtt.TrajectorySettings(
        delta_t=120, simulation_duration=120 * 20, record_t=120 * 20,
        particle_depths=depths, fail_mode=mtt.FailMode.ZERO)
    # the pathline gate blends the two snapshots over its own 20 steps, so
    # its alphas sweep the whole range 0..1
    gate_pcfg = mtt.TrajectorySettings(
        delta_t=PATH_DT, simulation_duration=PATH_DT * 20,
        record_t=PATH_DT * 4, particle_depths=depths,
        fail_mode=mtt.FailMode.ZERO)
    for label, run_cfg, pathline in (("", gate_cfg, False),
                                     (" pathline", gate_pcfg, True)):
        for real, tag in ((f32, "f32"), (f64, "f64")):
            mesh = meshes[real]
            sol = sols["front" if pathline else "stream", real]
            back = sols["back", real] if pathline else None
            key = f"{tag}{label}"
            plain = timed(f"{key} plain path, 20 steps",
                          lambda: mtt.run_advection(
                              mesh, sol, seeds, cells, run_cfg, back=back,
                              use_kernel=False))
            for windowed in (True, False):
                kpath = "window" if windowed else "full-column"
                fast = timed(f"{key} {kpath} kernel path, 20 steps",
                             lambda: mtt.run_advection(
                                 mesh, sol, seeds, cells, run_cfg, back=back,
                                 use_window=windowed))
                g = gate_check(fast.final_position, plain.final_position,
                               seeds, real,
                               fast.attrs if pathline else None,
                               plain.attrs if pathline else None)
                extra = "" if g["attr_share"] is None else (
                    f"; attribute records within {ATTR_REL_TOL:.0e} of the "
                    f"largest on {100 * g['attr_share']:.3f}% of those lanes")
                per = times[f"{key} {kpath} kernel path, 20 steps"] / 20
                log(f"  {key} {kpath}: {100 * g['share']:.3f}% of lanes within "
                    f"{g['tol_m']:.1f} m (min {100 * g['share_min']:.2f}%); "
                    f"median displacement kernel {g['disp_kernel_m']:.3f} m vs"
                    f" plain {g['disp_plain_m']:.3f} m{extra}; per step kernel "
                    f"path {1e3 * per:.3f} ms, plain path "
                    f"{1e3 * times[f'{key} plain path, 20 steps'] / 20:.3f} "
                    f"ms ({smi})")
                if not g["verified"]:
                    fail(f"gate {key} {kpath}")
                del fast
            del plain

    # ---- phase 4: where the device time goes -----------------------------
    log(f"[phase 4] torch.profiler over a {PROFILE_STEPS}-step run of each "
        f"kernel path (set-up included, after one warm-up run)")
    prof_cfg = mtt.TrajectorySettings(
        delta_t=120, simulation_duration=120 * PROFILE_STEPS, record_t=360,
        particle_depths=depths, fail_mode=mtt.FailMode.ZERO)
    prof_pcfg = mtt.TrajectorySettings(
        delta_t=PATH_DT, simulation_duration=PATH_DT * PROFILE_STEPS,
        record_t=PATH_DT * 3, particle_depths=depths,
        fail_mode=mtt.FailMode.ZERO)
    profile_rows = {}
    for label, pcfg_, kname, pathline, windowed in (
            (" window", prof_cfg, "window_streamline_kernel", False, True),
            ("", prof_cfg, "streamline_step_kernel", False, False),
            (" pathline window", prof_pcfg, "window_pathline_kernel", True,
             True),
            (" pathline", prof_pcfg, "pathline_step_kernel", True, False)):
        for real, tag in ((f32, "f32"), (f64, "f64")):
            mesh = meshes[real]
            sol = sols["front" if pathline else "stream", real]
            back = sols["back", real] if pathline else None

            def run():
                return mtt.run_advection(mesh, sol, seeds, cells, pcfg_,
                                         back=back, use_window=windowed)
            warm = run()
            busy, window, per_name, gap = device_breakdown(run)
            top = sorted(per_name.items(), key=lambda kv: -kv[1])
            k_ms = sum(ms for name, ms in per_name.items() if kname in name)
            if k_ms == 0.0:
                fail(f"profile {tag}{label}: no {kname} on the device")
            # the window paths' masked repair launch, apart from K3/K4
            repair = "pathline_step_kernel" if pathline \
                else "streamline_step_kernel"
            r_ms = sum(ms for name, ms in per_name.items() if repair in name) \
                if windowed else 0.0
            shares = miss_shares(warm, PROFILE_STEPS) if windowed else None
            log(f"  {tag}{label}: device busy {busy:.3f} ms of a "
                f"{window:.3f} ms window, idle share "
                f"{100 * (1 - busy / window):.2f}%; {kname} {k_ms:.3f} ms "
                f"({100 * k_ms / busy:.2f}% of busy)"
                + (f"; masked repair {repair} {r_ms:.3f} ms, "
                   f"{1e3 * r_ms / PROFILE_STEPS:.2f} us a step; "
                   + miss_line(shares) if windowed else "") + f" ({smi})")
            del warm
            log(f"    longest idle gap {gap[0]:.3f} ms at {gap[1]:.3f} ms "
                f"into the window, before {gap[2][:60]}")
            for name, ms in top[:8]:
                log(f"    {ms:9.3f} ms {100 * ms / busy:6.2f}%  {name[:90]}")
            profile_rows[f"{tag}{label}"] = {
                "busy_ms": busy, "window_ms": window, "kernel_ms": k_ms,
                "longest_gap_ms": gap[0],
                "top": [[nm[:90], ms] for nm, ms in top[:8]]}
            if windowed:
                profile_rows[f"{tag}{label}"].update(repair_ms=r_ms,
                                                     misses=shares)
                rows["k2" if pathline else "k1"].setdefault(
                    "repair_ms_per_step", {})[tag] = r_ms / PROFILE_STEPS

    # ---- phase 5: remap, the API and the CLI on the card ----------------
    remap_summary, api_summary = front_door(
        dev, mesh_h, sols, seeds, cfg, pcfg, last_points, launches,
        reset_counts, timed, times, smi)

    # ---- phase 6: the multi-device engines on the card -------------------
    multi_summary = multi_device(
        dev, mesh_h, sols, seeds, cells, depths, cfg, pcfg, refs, summary,
        launches, reset_counts, timed, times, smi)

    # ---- phase 7: across processes, the agent and the frontend ----------
    t_phase7 = time.perf_counter()
    process_summary = multi_process(dev, mesh_h, sols, seeds, cells, depths,
                                    cfg, refs, timed, times, smi)
    del refs
    process_summary["7d"] = agent_front_end(dev, times, smi)
    times["phase 7"] = time.perf_counter() - t_phase7
    log(f"  phase 7: {times['phase 7']:.3f} s (budget {PHASE7_BUDGET} s)")
    for key, repair_of in (("k1", "k3"), ("k2", "k4"), ("k3", None),
                           ("k4", None)):
        rows[key]["phase6_launches"] = {
            sub: row["launches"][key] + (row["launches"][f"{repair_of} repair"]
                                         if repair_of else 0)
            for sub, row in multi_summary.items()
            if isinstance(row, dict) and "launches" in row}
    # phase 7's launches, the ranks' and the jobs' processes summed
    sum_ranks = lambda ranks: {k: sum(r["launches"][k] for r in ranks)
                               for k in sk.COUNT_KEYS}
    phase7 = {"7a": sum_ranks(process_summary["7a"]["ranks"]),
              "7b": sum_ranks(process_summary["7b"]["ranks"]),
              "7c": process_summary["7c"]["launches"]}
    phase7.update({f"7d {task}": row["launches"]
                   for task, row in process_summary["7d"].items()})
    for key, repair_of in (("k1", "k3"), ("k2", "k4"), ("k3", None),
                           ("k4", None)):
        rows[key]["phase7_launches"] = {
            sub: c[key] + (c[f"{repair_of} repair"] if repair_of else 0)
            for sub, c in phase7.items()}

    # ---- phase 8: the 80-layer path, the configs and the tutorials -------
    refscale_summary = reference_scale(dev, rows, ptxas, timed, times, smi)

    # ---- the kernels' bounds at the main paths' start inputs -------------
    bounds = {}
    for key, pathline, n_attrs, n_window in (
            ("k1", False, 0, None), ("k2", True, 2, None),
            ("k3", False, 0, WINDOW), ("k4", True, 2, WINDOW)):
        for real, tag in ((f32, "f32"), (f64, "f64")):
            names = ["front", "back"] if pathline else ["stream"]
            b_ms, b_by, nbytes, ops = step_bound(
                meshes[real], [sols[k, real] for k in names], seeds, cells,
                depths, n_attrs, tag, n_window)
            bounds[f"{key} {tag}"] = (b_ms, b_by)
            log(f"  bound {key} {tag}: {b_ms:.4f} ms ({b_by}; "
                f"{nbytes / 1e6:.3f} MB, {ops / 1e9:.3f} G operations per "
                "step)")
        rows[key].update(bound_ms=bounds[f"{key} f32"][0],
                         bound_by=bounds[f"{key} f32"][1], library_ms=None)

    log(json.dumps({"phase_seconds": times, "build_seconds": build_s,
                    "main_paths": summary, "remap": remap_summary,
                    "api": api_summary, "multi_device": multi_summary,
                    "multi_process": process_summary,
                    "reference_scale": refscale_summary,
                    "rising_columns": rising,
                    "bounds_ms": {k: v[0] for k, v in bounds.items()},
                    "profile": profile_rows}))
    replaces = {"k1": "mops_tpu/pallas/stage_kernel.py:479",
                "k2": "mops_tpu/pallas/stage_kernel.py:502",
                "k3": "mops_tpu/pallas/window_kernel.py:509",
                "k4": "mops_tpu/pallas/window_kernel.py:544",
                "k5": "prof_dma.py:6"}
    sources = {key: "mops_tpu_torch/csrc/stage_kernel.cu" for key in kernels}
    sources["k5"] = "mops_tpu_torch/csrc/row_gather.cu"
    log(json.dumps({"kernels": [
        {"name": kernels[key].__name__, "route": "cuda",
         "source": sources[key], "replaces": replaces[key], **rows[key]}
        for key in kernels]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase7-worker"]:
        sys.exit(phase7_worker(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--window-ab"]:
        sys.exit(window_ab(sys.argv[2]))
    main()
