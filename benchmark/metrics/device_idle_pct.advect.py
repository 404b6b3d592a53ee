"""device_idle_pct.advect: the device's idle share from the first to the
last device activity of each traced trajectory request's run_advection
through the read-back of its records (profiler).  Moves
particle_steps_per_s."""

from benchmark.tracing import advect_window, union_us


def read(ctx):
    busy = window = 0.0
    for req in ctx.requests:
        win = advect_window(ctx, req) if req.steps else None
        if win is not None:
            t0, t1, evs = win
            busy += union_us([(s, min(e, t1)) for _, s, e in evs])
            window += t1 - t0
    return 100.0 * (1.0 - busy / window) if window > 0 else None
