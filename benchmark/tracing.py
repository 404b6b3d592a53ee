"""The traced run: host spans around the program's module functions that
the API calls, the device's activity from torch.profiler, and the context
the per-layer readers (metrics/<name>.py) read.

Spans wrap, in the traced run only: ``advect.run_advection`` ("step loop"),
``trajectory.finalize_trajectories`` ("finalize"), ``Field.
calc_in_which_cells`` ("cell search") and ``remap.run_remapping``
("remap"); the harness adds "request" around each API call.  Span times are
taken on the clock the profiler stamps its events with (the wall clock in
nanoseconds), so a device event and a host span share one time axis, in
microseconds from the profiler's start.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import time
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parent
KERNEL_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass
class Span:
    label: str
    start: float          # us from the profiler's start
    end: float
    request: int


@dataclasses.dataclass
class Request:
    """A traced request: its kind, its span and its steps (0 for an
    image)."""

    index: int
    kind: str
    start: float
    end: float
    steps: int = 0


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: device events (name, start, end) in
    us, sorted by start (copies and fills among them: is_copy); the host
    spans; the traced requests; ``step_bytes`` {request index: least bytes
    of one step} and the card's peaks; of the whole window, traced or
    not: ``request_s``, the seconds of every request that returned,
    ``work`` (steps or pixels) and ``window_s``."""

    events: list
    spans: list
    requests: list
    step_bytes: dict
    peaks: dict
    request_s: list = dataclasses.field(default_factory=list)
    work: float = 0.0
    window_s: float = 0.0

    def spans_of(self, request: int, label: str) -> list:
        return [s for s in self.spans if s.request == request
                and s.label == label]

    def events_in(self, t0: float, t1: float) -> list:
        return [e for e in self.events if t0 <= e[1] < t1]


def is_copy(name: str) -> bool:
    return name.startswith(KERNEL_PREFIXES)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_us(events) -> float:
    """The device time of the kernels among ``events`` (copies and fills
    left out), the union of their intervals."""
    return union_us([(s, e) for name, s, e in events if not is_copy(name)])


def advect_window(ctx: Context, req: Request):
    """(start, end, events) of a trajectory request's device work: from its
    first device event after the step loop began to the last one that began
    before finalize (the records' read-back included); None if none."""
    loop = ctx.spans_of(req.index, "step loop")
    fin = ctx.spans_of(req.index, "finalize")
    if not loop or not fin:
        return None
    evs = ctx.events_in(loop[0].start, fin[0].start)
    if not evs:
        return None
    return evs[0][1], max(e[2] for e in evs), evs


class Tracer:
    """Spans and the profiler of one traced run."""

    def __init__(self, device_type: str):
        self.device_type = device_type
        self.spans_ns: list = []
        self.request = -1
        self.misses: list = []
        self._patches: list = []
        self._prof = None
        self.trace_start_ns = None
        self.device_events: list = []

    # -- spans ----------------------------------------------------------------
    def wrap(self, owner, name: str, label: str,
             keep: Optional[Callable] = None) -> None:
        """Replace owner.name by a wrapper that records a span (and passes
        its result to ``keep``)."""
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.time_ns()
            try:
                out = fn(*args, **kwargs)
            finally:
                self.spans_ns.append((label, t0, time.time_ns(),
                                      self.request))
            if keep is not None:
                keep(out)
            return out
        setattr(owner, name, spanned)
        self._patches.append((owner, name, fn))

    def patch_program(self) -> None:
        from mops_tpu_torch import advect, field, remap, trajectory

        def keep_misses(raw):
            if getattr(raw, "window_misses", None) is not None:
                self.misses.append((raw.window_misses,
                                    raw.window_clamp_misses))
        self.wrap(advect, "run_advection", "step loop", keep_misses)
        self.wrap(trajectory, "finalize_trajectories", "finalize")
        self.wrap(field.Field, "calc_in_which_cells", "cell search")
        self.wrap(remap, "run_remapping", "remap")

    def unpatch(self) -> None:
        for owner, name, fn in reversed(self._patches):
            setattr(owner, name, fn)
        self._patches.clear()

    def record(self, label: str, t0_ns: int, t1_ns: int, request: int):
        self.spans_ns.append((label, t0_ns, t1_ns, request))

    # -- the profiler -----------------------------------------------------------
    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if self.device_type == "cuda" \
            else [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> None:
        """Stop the profiler and keep its device events."""
        import torch
        from torch.autograd import DeviceType
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        kr = self._prof.profiler.kineto_results
        self.trace_start_ns = kr.trace_start_ns()
        out = []
        for e in kr.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() if hasattr(e, "start_ns") \
                else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") \
                else e.duration_us() * 1000
            s = (start - self.trace_start_ns) / 1e3
            out.append((e.name(), s, s + dur / 1e3))
        out.sort(key=lambda e: e[1])
        self.device_events = out
        self._prof = None

    def context(self, requests: list, step_bytes: dict, peaks: dict) -> Context:
        base = self.trace_start_ns or 0
        spans = [Span(label, (t0 - base) / 1e3, (t1 - base) / 1e3, r)
                 for label, t0, t1, r in self.spans_ns]
        return Context(self.device_events, spans, requests, step_bytes, peaks)

    def rel_us(self, t_ns: int) -> float:
        return (t_ns - (self.trace_start_ns or 0)) / 1e3


def label_at(ctx: Context, req: Request, t: float) -> str:
    """What the host was doing at ``t`` within ``req``: the innermost span
    there, the read-back between the step loop and finalize, or "api"."""
    inner = [s for s in ctx.spans if s.request == req.index
             and s.label != "request" and s.start <= t < s.end]
    if inner:
        return min(inner, key=lambda s: s.end - s.start).label
    loop, fin = ctx.spans_of(req.index, "step loop"), \
        ctx.spans_of(req.index, "finalize")
    if loop and fin and loop[0].end <= t < fin[0].start:
        return "read-back"
    return "api"


def breakdown(ctx: Context) -> dict:
    """The ten device operations that took most time, by name, and the
    idle time of the traced requests summed by what the host was doing,
    the ten largest (seconds)."""
    per_name: dict = {}
    for name, s, e in ctx.events:
        per_name[name] = per_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    idle: dict = {}
    for req in ctx.requests:
        evs = ctx.events_in(req.start, req.end)
        t = req.start
        for _, s, e in evs + [("end", req.end, req.end)]:
            if s > t:
                label = label_at(ctx, req, 0.5 * (s + t))
                idle[label] = idle.get(label, 0.0) + (s - t) / 1e6
            t = max(t, e)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


def busy_window(ctx: Context):
    """(busy_s, window_s) of the traced requests: the union of device
    activity within them, and their summed length."""
    busy = window = 0.0
    for req in ctx.requests:
        busy += union_us([(max(s, req.start), min(e, req.end)) for _, s, e
                          in ctx.events_in(req.start, req.end)])
        window += req.end - req.start
    return busy / 1e6, window / 1e6


def load_reader(name: str, root: Path = ROOT):
    """metrics/<name>.py's ``read``."""
    path = Path(root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
