"""launches_per_step: device kernels (copies and fills apart) that a
trajectory request's step loop launches, from the step loop's start to
finalize's (its per-call set-up included), over its steps.  An exact
count, the mean over the traced requests.  Moves particle_steps_per_s."""

from benchmark.tracing import advect_window, is_copy


def read(ctx):
    counts = []
    for req in ctx.requests:
        win = advect_window(ctx, req) if req.steps else None
        if win is not None:
            n = sum(1 for name, _, _ in win[2] if not is_copy(name))
            counts.append(n / req.steps)
    return sum(counts) / len(counts) if counts else None
