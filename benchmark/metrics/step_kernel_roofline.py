"""step_kernel_roofline: the least time one step could take on the card
(benchmark/cost.py's least bytes of one step at the request's start inputs,
with a window of 8 layers whatever path the run takes, over the published
memory rate) over step_kernel_ms, over the traced trajectory requests.
Moves particle_steps_per_s."""

import importlib.util
from pathlib import Path

from benchmark.tracing import advect_window

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_step_kernel_ms",
    Path(__file__).with_name("step_kernel_ms.py"))
_ms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ms)


def read(ctx):
    bound_s = kernel_s = 0.0
    rate = ctx.peaks.get("bytes_per_s")
    for req in ctx.requests:
        win = advect_window(ctx, req) if req.steps else None
        nbytes = ctx.step_bytes.get(req.index)
        if win is None or not nbytes or not rate:
            continue
        us = _ms.kernel_us(win)
        if us > 0:
            bound_s += nbytes / rate * req.steps
            kernel_s += us / 1e6
    return 100.0 * bound_s / kernel_s if kernel_s > 0 else None
