"""step_kernel_ms: device time a step of the step kernels
(kernels/stage_kernel.py -> csrc/stage_kernel.cu: the full-column and
window kernels and their masked repairs, found by name in the profiler),
over the traced trajectory requests.  Moves particle_steps_per_s."""

from benchmark.tracing import advect_window

NAMES = ("streamline_step_kernel", "pathline_step_kernel",
         "window_streamline_kernel", "window_pathline_kernel")


def kernel_us(win):
    return sum(e - s for name, s, e in win[2]
               if any(k in name for k in NAMES))


def read(ctx):
    us = steps = 0.0
    for req in ctx.requests:
        win = advect_window(ctx, req) if req.steps else None
        if win is not None:
            us += kernel_us(win)
            steps += req.steps
    return us / 1e3 / steps if us > 0 else None
