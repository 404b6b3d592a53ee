"""One run of one cell: set-up, the measured window of requests through the
MOPS_* API, the reference check, and with a trace the per-layer metrics.

Everything a cell needs is found by name: the cell in BENCHMARK.json names
its configuration (configs/<name>.json, its mesh from meshgen) and its
traffic mix (traffic/<name>.json, read by traffic.py); its limits are
limits/<cell>.json and each per-layer metric metrics/<name>.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import check, cost, fields, meshgen, reference, tracing, traffic

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mops_tpu")
WARMUP = 4          # the seed stream of the warm-up request


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_spec(root: Path = REPO) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(spec: dict, workload: str):
    """(cell, configuration file, traffic mix) of a workload name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(REPO / entry["file"]) as f:
        config = json.load(f)
    return cell, config, traffic.load(cell["traffic"])


def metrics_of(spec: dict, group: str, workload: str) -> list:
    """The metrics of ``group`` ("end_to_end" or "per_layer") that a cell
    reports."""
    return [m for m in spec[group]
            if "workloads" not in m or workload in m["workloads"]]


def smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "clocks.mem,power.draw,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


@dataclasses.dataclass
class Run:
    """A cell's run: what set-up built and what the window did."""

    config: dict
    mix: dict
    seed: int
    device: torch.device
    arrays: dict = None
    app: object = None
    params: list = None
    attempted: int = 0
    failed: int = 0
    times: list = dataclasses.field(default_factory=list)
    work: float = 0.0
    window_s: float = 0.0
    samples: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.mix["request"]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def setup(run: Run, mesh_cache: Path = meshgen.CACHE_DIR,
          warm: bool = True) -> None:
    """The mesh (cached), the snapshots' raw fields made on the device and
    handed to the API, the app ready, and (unless ``warm`` is false) the
    warm-up requests of the cell's shapes."""
    from mops_tpu_torch import api
    from mops_tpu_torch.mesh import MPASMesh
    t0 = time.perf_counter()
    run.arrays, built = meshgen.load(run.config, mesh_cache)
    a = run.arrays
    log(f"# mesh {run.config['name']}: {len(a['xCell'])} cells, "
        f"{len(a['xVertex'])} vertices, maxEdges "
        f"{a['verticesOnCell'].shape[1]}, {'built' if built else 'cached'} "
        f"in {time.perf_counter() - t0:.3f} s")

    def xyz(name):
        return np.stack([a[f"{c}{name}"] for c in "xyz"], axis=-1)
    mesh = MPASMesh.from_raw(
        cell_xyz=xyz("Cell"), vertex_xyz=xyz("Vertex"), edge_xyz=xyz("Edge"),
        n_edges_on_cell=a["nEdgesOnCell"],
        vertices_on_cell_1based=a["verticesOnCell"],
        cells_on_cell_1based=a["cellsOnCell"],
        cells_on_vertex_1based=a["cellsOnVertex"],
        edges_on_cell_1based=a["edgesOnCell"],
        cells_on_edge_1based=a["cellsOnEdge"],
        vertices_on_edge_1based=a["verticesOnEdge"],
        ref_bottom_depth=a["refBottomDepth"], name=run.config["name"])
    app = api.MOPSApp()
    app.init(run.device, precision=run.config["precision"])
    app.begin()
    app.add_grid(mesh)
    run.params = traffic.snapshot_params(run.mix, run.seed)
    for i, raw in enumerate(raw_fields(run)):
        app.add_solution(i + 1, raw, timestamp=f"snapshot{i}", timestep=i)
        del raw
    app.end()
    if run.kind == "pathline":
        app.active_attribute(1, 2)
    run.app = app
    run.sync()
    t1 = time.perf_counter()
    if warm:
        warm_up(run)
        run.sync()
    log(f"# set-up in this function {time.perf_counter() - t0:.3f} s: "
        f"{t1 - t0:.3f} s to the app ready, "
        f"{time.perf_counter() - t1:.3f} s of warm-up requests")


def raw_fields(run: Run):
    """Each snapshot's raw cell fields, made on the device (float64)."""
    cells = torch.as_tensor(np.stack([run.arrays[f"{c}Cell"] for c in "xyz"],
                                     axis=-1), device=run.device)
    L = int(run.config["n_vert_levels"])
    for p in run.params:
        yield fields.solid_body(cells, L, p)


def settings(traj: dict, depths):
    from mops_tpu_torch.settings import (CalcDirection, CalcMethod,
                                         FailMode, TrajectorySettings)
    return TrajectorySettings(
        delta_t=int(traj["delta_t"]),
        simulation_duration=int(traj["duration"]),
        record_t=int(traj["record_t"]), particle_depths=depths,
        method=CalcMethod(traj.get("method", "rk4")),
        fail_mode=FailMode(traj.get("fail_mode", "zero")),
        direction=CalcDirection.BACKWARD
        if traj.get("direction", "forward") == "backward"
        else CalcDirection.FORWARD)


def image_settings(run: Run):
    from mops_tpu_torch.settings import (SaveType, VisualizationSettings,
                                         VisualizeType)
    im = run.mix["image"]
    return VisualizationSettings(
        image_width=int(im["width"]), image_height=int(im["height"]),
        lat_range=tuple(im["lat_range"]), lon_range=tuple(im["lon_range"]),
        fixed_depth=float(im["depth"]),
        visualize_type=VisualizeType.FIXED_DEPTH, save_type=SaveType.NONE)


def call(run: Run, k: int, job=None, traj: dict = None):
    """Request k through the API: the lines or images (``traj`` in place
    of the mix's integration, for a warm-up request)."""
    app = run.app
    if run.kind == "remap":
        app.active_attribute(k % len(run.params) + 1)
        return app.run_remapping(image_settings(run))
    cfg = settings(traj or run.mix["trajectory"], job.depths)
    seeds = job.seeds.copy()
    if run.kind == "pathline":
        return app.run_pathline(cfg, seeds)
    return app.run_streamline(cfg, seeds)


def warm_up(run: Run) -> None:
    """Requests of the cell's own shapes before the window: each snapshot
    once for an image mix; for a trajectory mix ``warmup_requests``
    requests of the full seed grid and record count at one record a step
    (the same lines and records for the host's finalize to warm on, which
    takes a process's first few requests, in a fraction of the steps),
    their seeds from a stream of their own."""
    if run.kind == "remap":
        for k in range(len(run.params)):
            call(run, k)
        return
    traj = run.mix["trajectory"]
    n_rec = int(traj["duration"]) // int(traj["record_t"])
    short = dict(traj, record_t=int(traj["delta_t"]),
                 duration=n_rec * int(traj["delta_t"]))
    other = int(traffic.rng(run.seed, WARMUP).integers(1 << 62))
    for k in range(int(run.mix["warmup_requests"])):
        call(run, k, job=traffic.trajectory_job(run.mix, other, k),
             traj=short)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def sample(run: Run, k: int, out, job) -> dict:
    """What the check keeps of request k's answer."""
    if run.kind == "remap":
        rows = traffic.check_rows(run.mix, run.seed, k)
        return {"k": k, "rows": rows, "snapshot": k % len(run.params),
                "got": [out[0][rows].copy(),
                        out[1][rows].copy() if len(out) > 1 else None]}
    lanes = traffic.check_lanes(run.mix, run.seed, k, job.n)
    got = {"points": np.stack([out[i].points for i in lanes]),
           "velocity": np.stack([out[i].velocity for i in lanes])}
    if out[0].attrs is not None:
        got["attrs"] = np.stack([out[i].attrs for i in lanes])
    return {"k": k, "seeds": job.seeds[lanes], "depths": job.depths[lanes],
            "got": got}


def window(run: Run, seconds: float, tracer=None) -> float:
    """Requests back to back until the first that ends after ``seconds``;
    returns the window's length.  With a tracer the first
    ``trace.requests`` requests are profiled."""
    n_traced = int(run.mix["trace"]["requests"]) if tracer else 0
    steps = traffic.n_steps(run.mix["trajectory"]) \
        if run.kind != "remap" else 0
    im = run.mix.get("image", {})
    pixels = int(im.get("width", 0)) * int(im.get("height", 0))
    t_start = time.perf_counter()
    k = 0
    while True:
        job = None if run.kind == "remap" \
            else traffic.trajectory_job(run.mix, run.seed, k)
        traced = k < n_traced
        if traced and k == 0:
            tracer.start()
        if tracer:
            tracer.request = k
        w0 = time.time_ns()
        t0 = time.perf_counter()
        try:
            out = call(run, k, job=job)
        except Exception:           # a request that raised is failed, not fatal
            traceback.print_exc(file=sys.stderr)
            out = None
        t1 = time.perf_counter()
        w1 = time.time_ns()
        run.attempted += 1
        if traced:
            tracer.record("request", w0, w1, k)
            run.requests.append(tracing.Request(k, run.kind, w0, w1, steps))
            if k == n_traced - 1:
                tracer.stop()
        if out is None:
            run.failed += 1
        else:
            run.times.append(t1 - t0)
            run.work += job.n * steps if job else pixels
            run.samples.append(sample(run, k, out, job))
        del out
        k += 1
        if t1 - t_start >= seconds:
            if tracer and tracer._prof is not None:
                tracer.stop()
            return t1 - t_start


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def reference_tables(run: Run, ar=reference.F64):
    """The reference's mesh and snapshots, worked out again from the same
    raw arrays."""
    mesh = reference.mesh_from_arrays(run.arrays, run.device)
    snaps = []
    for raw in raw_fields(run):
        snaps.append(reference.preprocess(mesh, raw, ar))
        del raw
    return mesh, snaps


def reference_answers(run: Run, mesh, snaps, ar=reference.F64) -> list:
    """The reference's answer to each sample, in order."""
    if run.kind == "remap":
        out = [None] * len(run.samples)
        for snap_i, snap in enumerate(snaps):
            mine = [i for i, s in enumerate(run.samples)
                    if s["snapshot"] == snap_i]
            if not mine:
                continue
            rows = np.unique(np.concatenate([run.samples[i]["rows"]
                                             for i in mine]))
            vel, att = reference.remap_rows(mesh, snap, run.mix["image"],
                                            rows, ar)
            where = {r: j for j, r in enumerate(rows)}
            for i in mine:
                j = [where[r] for r in run.samples[i]["rows"]]
                out[i] = [vel[j], None if att is None else att[j]]
        return out
    if not run.samples:
        return []
    seeds = np.concatenate([s["seeds"] for s in run.samples])
    depths = np.concatenate([s["depths"] for s in run.samples])
    lines = reference.trajectories(mesh, snaps, seeds, depths,
                                   run.mix["trajectory"], ar)
    out, a = [], 0
    for s in run.samples:
        b = a + len(s["seeds"])
        out.append({k: v[a:b] for k, v in lines.items()})
        a = b
    return out


def numbers_of(run: Run, answers: list) -> dict:
    per = [check.image_numbers(s["got"], w) if run.kind == "remap"
           else check.trajectory_numbers(s["got"], w)
           for s, w in zip(run.samples, answers)]
    return check.worst(per)


# ---------------------------------------------------------------------------
# a whole run
# ---------------------------------------------------------------------------

def finite(x):
    """A JSON number: non-finite values as the largest double."""
    if isinstance(x, float) and not np.isfinite(x):
        return 1.7976931348623157e308
    return x


def execute(workload: str, seed: int, seconds: float, trace: bool,
            t_process: float, device="cuda", spec: dict = None,
            mesh_cache: Path = meshgen.CACHE_DIR, limits: dict = None,
            shrink=None, out=None) -> dict:
    """One run; returns the result line's object (also printed to ``out``,
    default standard output, as its last line).  ``t_process`` is the
    process's start on the perf_counter clock.  ``shrink`` maps
    (configuration, mix) to smaller ones, for a run on the CPU in a test."""
    out = out or sys.stdout
    spec = spec or load_spec()
    cell, config, mix = cell_of(spec, workload)
    if shrink is not None:
        config, mix = shrink(config, mix)
    run = Run(config, mix, seed, torch.device(device))
    is_cuda = run.device.type == "cuda"
    with contextlib.redirect_stdout(sys.stderr):
        setup(run, mesh_cache)
        tracer = tracing.Tracer(run.device.type) if trace else None
        if tracer:
            tracer.patch_program()
        # an end-to-end metric from the device trace: in an untraced run
        # the profiler records the device over the whole window (started
        # in set-up)
        whole = None
        if not trace and is_cuda and any(
                m["source"] == "device_trace"
                for m in metrics_of(spec, "end_to_end", workload)):
            whole = tracing.Tracer(run.device.type)
            whole.start()
        if is_cuda:
            torch.cuda.reset_peak_memory_stats(run.device)
        t_window = time.perf_counter()
        setup_s = t_window - t_process
        window_s = run.window_s = window(run, seconds, tracer)
        if whole:
            whole.stop()
        peak = torch.cuda.max_memory_allocated(run.device) if is_cuda else 0
        if tracer:
            tracer.unpatch()
        from mops_tpu_torch import advect
        resolved = dict(advect.LAST_RESOLVED)
        misses = None
        if tracer and tracer.misses:
            misses = [sum(int(m.sum()) for m, _ in tracer.misses),
                      sum(int(c.sum()) for _, c in tracer.misses)]
            tracer.misses = []
        run.app = None
        if is_cuda:
            torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    log(f"# device: {torch.cuda.get_device_name(run.device) if is_cuda else 'cpu'}"
        f"; nvidia-smi (name, clocks.sm, clocks.max.sm, clocks.mem, "
        f"power.draw, power.limit): {smi() if is_cuda else 'n/a'}")
    log(f"# peak device memory {peak} B; LAST_RESOLVED {resolved}")
    if misses is not None:
        log(f"# window misses (edge or clamp) {misses[0]}, clamp misses "
            f"{misses[1]} over the window's {run.attempted} requests")
    log(f"# window {window_s:.3f} s, {run.attempted} requests, "
        f"{run.failed} failed; set-up {setup_s:.3f} s")

    # the reference check, on what the window produced
    t0 = time.perf_counter()
    mesh, snaps = reference_tables(run)
    answers = reference_answers(run, mesh, snaps)
    numbers = numbers_of(run, answers)
    limits = check.load_limits(workload) if limits is None else limits
    ok, table = check.judge(numbers, limits)
    log(f"# reference check {time.perf_counter() - t0:.3f} s over "
        f"{len(run.samples)} requests; numbers {numbers}")
    correct = ok and run.failed == 0 and len(run.samples) > 0

    if run.kind == "remap":
        e2e = {"image_kernel_ms": (
            tracing.kernel_us(whole.device_events) / 1e3 / len(run.times)
            if whole and run.times else None, "ms")}
    else:
        e2e = {"particle_steps_per_s": (run.work / window_s, "steps/s")}
    e2e["setup_s"] = (setup_s, "s")
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if is_cuda
           else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": run.failed}
    if trace:
        per = per_layer(run, tracer, spec, workload, mesh, snaps)
        ctx = per.pop("_ctx")
        busy_s, traced_s = tracing.busy_window(ctx)
        dev.update(busy_s=busy_s, window_s=traced_s)
        result["metrics"] = per
        result["device"] = dev
        result["breakdown"] = tracing.breakdown(ctx)
    else:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        result["metrics"] = {
            m["name"]: {"value": finite(e2e[m["name"]][0]),
                        "unit": units[m["name"]]}
            for m in metrics_of(spec, "end_to_end", workload)
            if e2e[m["name"]][0] is not None}
        result["device"] = dev
    result["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                        for k, v in table.items()}
    if run.times:
        q = statistics.quantiles(run.times, n=4) if len(run.times) > 1 \
            else [run.times[0]] * 3
        log(f"# request seconds: n {len(run.times)}, median {q[1]:.4f}, "
            f"quartiles {q[0]:.4f} / {q[2]:.4f}; in order "
            f"{[round(t, 4) for t in run.times]}")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    for name, row in result["checks"].items():
        log(f"check {name}: {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), file=out, flush=True)
    return result


def per_layer(run: Run, tracer, spec: dict, workload: str, mesh,
              snaps) -> dict:
    """The cell's per-layer metrics from the traced requests (a reader
    that finds nothing is left out), with the context under "_ctx"."""
    step_bytes = {}
    if run.kind != "remap":
        for req in run.requests:
            job = traffic.trajectory_job(run.mix, run.seed, req.index)
            cells = reference.nearest_cells(mesh, job.seeds)
            n_attrs = 2 if run.kind == "pathline" else 0
            step_bytes[req.index] = cost.step_cost(
                mesh, snaps, job.seeds, cells, job.depths, n_attrs,
                n_window=8, size=4)[0]
    reqs = [dataclasses.replace(r, start=tracer.rel_us(r.start),
                                end=tracer.rel_us(r.end))
            for r in run.requests]
    peaks = json.loads((ROOT / "peaks.json").read_text()).get(
        torch.cuda.get_device_name(run.device)
        if run.device.type == "cuda" else "", {})
    ctx = tracer.context(reqs, step_bytes, peaks)
    ctx.request_s, ctx.work, ctx.window_s = \
        list(run.times), run.work, run.window_s
    out = {}
    for m in metrics_of(spec, "per_layer", workload):
        value = tracing.load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"# traced: {len(ctx.events)} device events over {len(reqs)} "
        f"requests; step bytes {step_bytes}")
    out["_ctx"] = ctx
    return out
