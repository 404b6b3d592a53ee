#!/usr/bin/env python3
"""Smoke run of mops_tpu_torch on one CUDA card: build, check, run, gate.

    python3 chip_smoke.py

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
   2c. pathline, the default path, K4 and its K2 repair: the reference's
       pathline tutorial
       (tutorial/pathLine.cpp), two snapshots at ocean speeds (solid-body
       rotation at 3e-7 and 3.6e-7 rad/s, about 1.9 and 2.3 m/s at the
       equator) with temperature and salinity, RK4, dt 600 s for one month
       (4,320 steps), a record every 6 h;
   2d. the same through the full-column kernel, K2, and the two pathline
       runs held against each other.
3. gate: the first 20 steps through both kernel paths against the plain
   torch path on the card, streamline and pathline, float32 and float64.
4. profile: torch.profiler over a 30-step run of each kernel path, in
   float32 and float64: the device's busy time, its idle share and the
   time per device kernel (PERF.md, "Where the time goes"); on the window
   paths the masked K1 (K2) repair launches' device time apart from K3's
   (K4's).
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
       dtype, kernels and inputs), with the launch counts checked and the
       timing summary printed;
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

The line before the card's name lists each kernel with its launches on
its main path, its time and its plain version's time at the slice shape,
its bound: the larger of the bytes the step must move (each input read
once, each output written once, counted from this run's start inputs) over
the card's memory rate and the operations it does over the card's peak
rate, the time of the one PyTorch call that computes the same function
where there is one, and ptxas's registers and spills.
"""

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


def step_bound(mesh, sols, seeds, cells, depths, n_attrs, pathline, tag,
               n_window=None):
    """The least time one fused step could take on this card at the main
    path's start inputs: (bound_ms, bound_by, bytes, operations).

    Bytes: each input read once and each output written once.  Vertex rows
    that several particles share count once: xyz (from the front table) and
    the ztop every vertex a particle's cell uses, in each snapshot (the
    whole column, or with ``n_window`` the window's layers at the start
    position's window start plus the surface and bottom values), plus the
    velocity (3), vertical velocity (1) and attribute values of each
    distinct (vertex, layer) pair that the layers above and below the
    particle's depth pick; pos, depth, nv and the nv vertex ids (and the
    window start); the outputs.  The layers are those at the start position
    (a stage whose position crosses a layer reads more, and a window miss
    reads the full column, so this is a lower bound).  Operations: the
    leading terms of the kernel's loops over four RK4 stages (geometry ~85
    per vertex; per snapshot the profile 2*nv*(L or W) and the picks
    2*nv*(8 + 2A))."""
    import torch
    from mops_tpu_torch import advect
    from mops_tpu_torch.interp import wachspress_weights
    from mops_tpu_torch.step import (_clamp_profile, _layer_search_binary,
                                     _layer_search_linear, window_starts)
    dev = mesh.device
    real = mesh.dtype
    size = torch.finfo(real).bits // 8
    L = sols[0].vertex_ztop.shape[1]
    vids, nv, _ = advect._gather_cell_vertices(
        mesh, torch.as_tensor(cells, device=dev))
    K = vids.shape[1]
    valid = torch.arange(K, device=dev)[None, :] < nv[:, None]
    vid = vids.long()
    n_vert = int(torch.unique(vid[valid]).numel())
    pos = torch.as_tensor(seeds, device=dev, dtype=real)
    dn = -torch.as_tensor(depths, device=dev).to(real)
    w = wachspress_weights(pos, mesh.vertex_xyz[vid], nv)
    nbytes = n_vert * 3 * size
    per_lane_ops = 85 * nv.double()
    s = None
    if n_window:
        z = _clamp_profile(torch.einsum("nk,nkl->nl", w,
                                        sols[0].vertex_ztop[vid]), True)
        s = window_starts(_layer_search_binary(z, dn), L, n_window).long()
    for sol in sols:
        z = _clamp_profile(torch.einsum("nk,nkl->nl", w,
                                        sol.vertex_ztop[vid]), True)
        layer = _layer_search_linear(z, dn)[0] if pathline \
            else _layer_search_binary(z, dn)
        keys = torch.cat([(vid * L + (layer - 1)[:, None])[valid],
                          (vid * L + layer[:, None])[valid]])
        if n_window:
            lw = s[:, None, None] + torch.arange(n_window, device=dev)
            zkeys = (vid[:, :, None] * L + lw)[valid]
            nbytes += (int(torch.unique(zkeys).numel()) + 2 * n_vert) * size
            per_lane_ops += 2 * nv.double() * (n_window + 8 + 2 * n_attrs)
        else:
            nbytes += n_vert * L * size
            per_lane_ops += 2 * nv.double() * (L + 8 + 2 * n_attrs)
        nbytes += int(torch.unique(keys).numel()) * (3 + 1 + n_attrs) * size
    n = len(seeds)
    nbytes += n * (4 * size + 4) + 4 * int(nv.sum())             # inputs
    nbytes += n * (7 * size + 1 + (3 * size if n_attrs else 0))  # outputs
    if n_window:
        nbytes += n * (4 + 4 + 1)                    # start in; layer, miss out
    ops = 4 * float(per_lane_ops.sum())
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


def front_door(dev, mesh_h, sols, seeds, cfg, pcfg, last_points, kernels,
               reset_counts, timed, times, smi):
    """Phase 5: remap, the API and the CLI on ``dev`` at the slice's shape.
    ``sols`` maps (name, dtype) to phase 0's preprocessed fields,
    ``last_points`` phase 2's window paths' last points ("k3", "k4");
    ``kernels`` the launch-counted wrappers and ``reset_counts`` their
    reset.  Returns the remap and API summaries."""
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
        times[f"5a {label} host KD query"] = time.perf_counter() - t
        log(f"  {label} host KD query ({len(out[1])} pixels, cKDTree): "
            f"{times[f'5a {label} host KD query']:.3f} s")
        return out

    for w, h, depth in REMAP_SHAPES:
        vis = mtt.VisualizationSettings(image_width=w, image_height=h,
                                        fixed_depth=depth)
        label = f"remap {w}x{h} at {depth:g} m"
        pix, pcells = kd_query(label, vis, "remap",
                               lambda: rm._pixel_positions(vis))
        imgs, row = {}, {"pixels": w * h,
                         "kd_query_s": times[f"5a {label} host KD query"]}
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
        counts = {k: fn.launches for k, fn in kernels.items()}
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
        with open(os.path.join(out, "streamline.vtp")) as f:
            head = f.read(400)
    found = re.search(r'NumberOfPoints="(\d+)" NumberOfLines="(\d+)"', head)
    n_pts, n_lines = map(int, found.groups()) if found else (0, 0)
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
                 summary, kernels, reset_counts, timed, times, smi):
    """Phase 6: the sharded and migrating engines on the card, their shards
    all on ``dev``.  ``refs`` holds phase 2's RawTrajectories by kernel
    (k3: 2a, k1: 2b, k4: 2c), ``summary`` phase 2's rates.  Returns the
    phase's summary (launches per sub-phase, rates, shares)."""
    import numpy as np
    import torch

    import mops_tpu_torch as mtt
    from mops_tpu_torch import api
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
        c = {k: fn.launches for k, fn in kernels.items()}
        c.update({f"{k} repair": kernels[k].repair_launches
                  for k in ("k3", "k4")})
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
    from mops_tpu_torch.kernels import stage_kernel as sk
    from mops_tpu_torch.kernels.stage_kernel import pack_vertex_table
    from mops_tpu_torch.prof_dma import BACK_OMEGA, FIELD_KW, PATH_OMEGA, \
        SLICE_LAYERS, event_ms
    from mops_tpu_torch.step import (_clamp_profile, _layer_search_binary,
                                     _layer_search_linear, window_starts)

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    sync = torch.cuda.synchronize
    kernels = {
        "k1": sk.fused_streamline_step, "k2": sk.fused_pathline_step,
        "k3": sk.fused_window_streamline_step,
        "k4": sk.fused_window_pathline_step, "k5": rg.row_gather_probe}
    windowed_fns = (sk.fused_window_streamline_step,
                    sk.fused_window_pathline_step)

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0
        for fn in windowed_fns:
            fn.repair_launches = 0

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
    idx = np.arange(n)
    cells_chk = cells.copy()
    coc = mesh_h.cells_on_cell.numpy()
    move = (idx % 97 == 3) & (coc[cells, 0] >= 0)
    cells_chk[move] = coc[cells[move], 0]                 # out of cell
    depth_chk = -depths.astype(np.float64)
    depth_chk[idx % 89 == 5] = -5000.0                    # below the bottom
    depth_chk[idx % 83 == 7] = 5.0                        # above the surface
    seeds_chk = seeds.copy()
    seeds_chk[idx % 1009 == 11] = np.nan                  # dead lanes
    shift = np.where(idx % 61 == 17, WINDOW, np.where(idx % 61 == 29,
                                                      -WINDOW, 0))
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
    # K1's and K2's main-path instances (plain, L <= 64) hold their
    # register caps without spilling
    spilled = [label for key in ("k1", "k2")
               for label, rep in rows[key]["ptxas"].items()
               if label.endswith(" 64 0") and rep["spill_stores"]]
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

    def lane_inputs(real):
        mesh = meshes[real]
        vids, nv, _ = advect._gather_cell_vertices(
            mesh, torch.as_tensor(cells_chk, device=dev))
        pos = torch.as_tensor(seeds_chk, device=dev, dtype=real)
        dn = torch.as_tensor(depth_chk, device=dev, dtype=real)
        return pos, dn, nv, vids

    def table(sol, real, n_attrs=0):
        attrs = advect.stacked_vertex_attrs(sol)[..., :n_attrs] \
            if n_attrs else None
        return pack_vertex_table(meshes[real].vertex_xyz, sol.vertex_ztop,
                                 sol.vertex_velocity,
                                 sol.vertex_vert_velocity, attrs)

    def starts(pos, dn, nv, vids, tab):
        """Window starts around each lane's layer, as run_advection places
        them (timed), and the same moved a window away on some lanes so that
        they miss (checked)."""
        rows_ = tab[vids.long()]
        w = wachspress_weights(pos, rows_[..., :3], nv)
        z = _clamp_profile(torch.einsum("nk,nkl->nl", w,
                                        rows_[..., 3:3 + L]), True)
        s = window_starts(_layer_search_binary(z, dn), L, WINDOW)
        moved = s.long() + torch.as_tensor(shift, device=dev)
        return s.contiguous(), torch.clamp(moved, 0, L - WINDOW).to(
            torch.int32).contiguous()

    def check(key, name, call, plain, dt, flags=(3,), attr=None,
              timed_case=False, real=f32, timed_calls=None):
        """Hold ``call`` against ``plain``; on the timed case, time both per
        step (or the pair ``timed_calls``: the window kernels are timed at
        the main path's window starts); with ``timed_case="euler"`` time the
        kernel alone (its one-stage form: RK4's time less Euler's is three
        stages' work)."""
        got = call()
        sync()
        want = plain()
        sync()
        errs, tol, flips, outliers, passed, note = compare_step(
            got, want, real, dt, flags, attr)
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
        if timed_case:
            k_call, p_call = timed_calls or (call, plain)
            ms = event_ms(k_call, 20)
            if timed_case == "euler":
                log(f"  per step at the slice shape, {key} {name}: kernel "
                    f"{ms:.3f} ms ({smi})")
                if real == f32:
                    rows[key]["euler_ms"] = ms
                return
            plain_ms = event_ms(p_call, 3)
            log(f"  per step at the slice shape, {key} {name}: kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms ({smi})")
            if real == f32:
                rows[key].update(max_abs_err=errs[0], ms=ms,
                                 plain_ms=plain_ms)

    mid = PATH_STEPS // 2
    alpha_sets = {"mid": mid / PATH_STEPS,
                  "near 1": (PATH_STEPS - 1) / PATH_STEPS}
    for real, tag in ((f32, "f32"), (f64, "f64")):
        pos, dn, nv, vids = lane_inputs(real)
        tab = table(sols["stream", real], real)
        s0, s = starts(pos, dn, nv, vids, tab)
        for euler in (False, True):
            name = f"{tag} {'euler' if euler else 'rk4'}"
            check("k1", name,
                  lambda: sk.fused_streamline_step(pos, dn, nv, vids, tab, L,
                                                   120.0, euler=euler),
                  lambda: sk.fused_streamline_step_plain(
                      pos, dn, nv, vids, tab, L, 120.0, euler=euler),
                  120.0, timed_case="euler" if euler else True, real=real)
            check("k3", name,
                  lambda: sk.fused_window_streamline_step(
                      pos, dn, nv, vids, s, tab, L, WINDOW, 120.0,
                      euler=euler),
                  lambda: sk.fused_window_streamline_step_plain(
                      pos, dn, nv, vids, s, tab, L, WINDOW, 120.0,
                      euler=euler),
                  120.0, flags=(3, 4, 5),
                  timed_case="euler" if euler else True, real=real,
                  timed_calls=(
                      lambda: sk.fused_window_streamline_step(
                          pos, dn, nv, vids, s0, tab, L, WINDOW, 120.0,
                          euler=euler),
                      lambda: sk.fused_window_streamline_step_plain(
                          pos, dn, nv, vids, s0, tab, L, WINDOW, 120.0)))
        del tab
        for n_attrs in (0, 2):
            tf = table(sols["front", real], real, n_attrs)
            tb = table(sols["back", real], real, n_attrs)
            sp0, sp = starts(pos, dn, nv, vids, tf)
            for euler in (False, True):
                for a_name, a1 in alpha_sets.items():
                    alphas = advect.stage_alphas(
                        a1, PATH_DT, PATH_DT * PATH_STEPS, real)
                    name = (f"{tag} {'euler' if euler else 'rk4'} "
                            f"A={n_attrs} alphas {a_name} "
                            f"{[float(a) for a in alphas]}")
                    timed_case = n_attrs and a_name == "mid" and (
                        "euler" if euler else True)
                    check("k2", name,
                          lambda: sk.fused_pathline_step(
                              pos, dn, nv, vids, tf, tb, L, PATH_DT, alphas,
                              euler=euler, n_attrs=n_attrs),
                          lambda: sk.fused_pathline_step_plain(
                              pos, dn, nv, vids, tf, tb, L, PATH_DT, alphas,
                              euler=euler, n_attrs=n_attrs),
                          PATH_DT, attr=4 if n_attrs else None,
                          timed_case=timed_case, real=real)
                    check("k4", name,
                          lambda: sk.fused_window_pathline_step(
                              pos, dn, nv, vids, sp, tf, tb, L, WINDOW,
                              PATH_DT, alphas, euler=euler, n_attrs=n_attrs),
                          lambda: sk.fused_window_pathline_step_plain(
                              pos, dn, nv, vids, sp, tf, tb, L, WINDOW,
                              PATH_DT, alphas, euler=euler, n_attrs=n_attrs),
                          PATH_DT, flags=(3, 4, 5),
                          attr=6 if n_attrs else None,
                          timed_case=timed_case, real=real,
                          timed_calls=(
                              lambda: sk.fused_window_pathline_step(
                                  pos, dn, nv, vids, sp0, tf, tb, L, WINDOW,
                                  PATH_DT, alphas, euler=euler,
                                  n_attrs=n_attrs),
                              lambda: sk.fused_window_pathline_step_plain(
                                  pos, dn, nv, vids, sp0, tf, tb, L, WINDOW,
                                  PATH_DT, alphas, n_attrs=n_attrs)))
            del tf, tb
        del pos, dn, nv, vids

    # ---- phase 1c: the row-gather probe (K5) ----------------------------
    log("[phase 1c] row-gather probe K5: its main path (python -m "
        "mops_tpu_torch.prof_dma) at (a) prof_dma.py's shape, then kernel "
        "vs plain vs index_select at (a), (b) the streamline table and (c) "
        "the pathline front table")
    reset_counts()
    probe, tab_a, ids_a = timed("prof_dma main path",
                                lambda: prof_dma.main([]))
    rows["k5"]["launches"] = rg.row_gather_probe.launches
    if rows["k5"]["launches"] == 0 or sum(
            fn.launches for fn in kernels.values()) \
            != rows["k5"]["launches"]:
        fail(f"launch counts of the probe's main path: "
             f"{ {k: fn.launches for k, fn in kernels.items()} }")
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
            ("(b) streamline", table(sols["stream", f32], f32)),
            ("(c) pathline front", table(sols["front", f32], f32, 2))):
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
        counts = {k: fn.launches for k, fn in kernels.items()}
        repairs = kernels[key].repair_launches if windowed else 0
        rate = n * run_cfg.n_steps / times[f"run_advection {label}"]
        misses = 0 if raw_traj.window_misses is None \
            else int(raw_traj.window_misses.sum())
        log(f"  launches {counts}, repair launches {repairs} for "
            f"{run_cfg.n_steps} steps; {rate:.6e} "
            f"particle-RK4-steps/s end to end; window misses {misses} "
            f"({100 * misses / (n * run_cfg.n_steps):.4f}% of particle-steps)"
            f" ({smi})")
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
        if frac < 0.995:
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
            ep = plain.final_position.double().cpu().numpy()
            d_e = float(np.median(np.linalg.norm(ep - seeds, axis=1)))
            for windowed in (True, False):
                kpath = "window" if windowed else "full-column"
                fast = timed(f"{key} {kpath} kernel path, 20 steps",
                             lambda: mtt.run_advection(
                                 mesh, sol, seeds, cells, run_cfg, back=back,
                                 use_window=windowed))
                fp = fast.final_position.double().cpu().numpy()
                err = np.linalg.norm(fp - ep, axis=1)
                d_f = float(np.median(np.linalg.norm(fp - seeds, axis=1)))
                tol = max(100.0, 1e-4 * max(d_e, 1.0))
                within = err <= tol
                frac = float(within.mean())
                extra = ""
                attr_ok = True
                if pathline:
                    fa, ea = fast.attrs.double(), plain.attrs.double()
                    a_tol = F32_REL_TOL * float(ea.abs().max())
                    lane = ((fa - ea).abs().amax(dim=(1, 2))
                            <= a_tol).cpu().numpy()
                    a_frac = float(lane[within].mean())
                    attr_ok = a_frac >= 0.995
                    extra = (f"; attribute records within {a_tol:.2e} on "
                             f"{100 * a_frac:.3f}% of those lanes")
                per = times[f"{key} {kpath} kernel path, 20 steps"] / 20
                log(f"  {key} {kpath}: {100 * frac:.3f}% of lanes within "
                    f"{tol:.1f} m; median displacement kernel {d_f:.3f} m vs"
                    f" plain {d_e:.3f} m{extra}; per step kernel path "
                    f"{1e3 * per:.3f} ms, plain path "
                    f"{1e3 * times[f'{key} plain path, 20 steps'] / 20:.3f} "
                    f"ms ({smi})")
                if frac < 0.995 or abs(d_f - d_e) > 0.05 * max(d_e, 1.0) \
                        or not attr_ok:
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
                mtt.run_advection(mesh, sol, seeds, cells, pcfg_, back=back,
                                  use_window=windowed)
            run()
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
            log(f"  {tag}{label}: device busy {busy:.3f} ms of a "
                f"{window:.3f} ms window, idle share "
                f"{100 * (1 - busy / window):.2f}%; {kname} {k_ms:.3f} ms "
                f"({100 * k_ms / busy:.2f}% of busy)"
                + (f"; masked repair {repair} {r_ms:.3f} ms, "
                   f"{1e3 * r_ms / PROFILE_STEPS:.2f} us a step"
                   if windowed else "") + f" ({smi})")
            log(f"    longest idle gap {gap[0]:.3f} ms at {gap[1]:.3f} ms "
                f"into the window, before {gap[2][:60]}")
            for name, ms in top[:8]:
                log(f"    {ms:9.3f} ms {100 * ms / busy:6.2f}%  {name[:90]}")
            profile_rows[f"{tag}{label}"] = {
                "busy_ms": busy, "window_ms": window, "kernel_ms": k_ms,
                "longest_gap_ms": gap[0],
                "top": [[nm[:90], ms] for nm, ms in top[:8]]}
            if windowed:
                profile_rows[f"{tag}{label}"]["repair_ms"] = r_ms
                rows["k2" if pathline else "k1"].setdefault(
                    "repair_ms_per_step", {})[tag] = r_ms / PROFILE_STEPS

    # ---- phase 5: remap, the API and the CLI on the card ----------------
    remap_summary, api_summary = front_door(
        dev, mesh_h, sols, seeds, cfg, pcfg, last_points, kernels,
        reset_counts, timed, times, smi)

    # ---- phase 6: the multi-device engines on the card -------------------
    multi_summary = multi_device(
        dev, mesh_h, sols, seeds, cells, depths, cfg, pcfg, refs, summary,
        kernels, reset_counts, timed, times, smi)
    del refs
    for key, repair_of in (("k1", "k3"), ("k2", "k4"), ("k3", None),
                           ("k4", None)):
        rows[key]["phase6_launches"] = {
            sub: row["launches"][key] + (row["launches"][f"{repair_of} repair"]
                                         if repair_of else 0)
            for sub, row in multi_summary.items()
            if isinstance(row, dict) and "launches" in row}

    # ---- the kernels' bounds at the main paths' start inputs -------------
    bounds = {}
    for key, pathline, n_attrs, n_window in (
            ("k1", False, 0, None), ("k2", True, 2, None),
            ("k3", False, 0, WINDOW), ("k4", True, 2, WINDOW)):
        for real, tag in ((f32, "f32"), (f64, "f64")):
            names = ["front", "back"] if pathline else ["stream"]
            b_ms, b_by, nbytes, ops = step_bound(
                meshes[real], [sols[k, real] for k in names], seeds, cells,
                depths, n_attrs, pathline, tag, n_window)
            bounds[f"{key} {tag}"] = (b_ms, b_by)
            log(f"  bound {key} {tag}: {b_ms:.4f} ms ({b_by}; "
                f"{nbytes / 1e6:.3f} MB, {ops / 1e9:.3f} G operations per "
                "step)")
        rows[key].update(bound_ms=bounds[f"{key} f32"][0],
                         bound_by=bounds[f"{key} f32"][1], library_ms=None)

    log(json.dumps({"phase_seconds": times, "build_seconds": build_s,
                    "main_paths": summary, "remap": remap_summary,
                    "api": api_summary, "multi_device": multi_summary,
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
    main()
