"""device_idle_pct.remap: the device's idle share from the first to the
last device activity of each traced image request (profiler).  Moves
image_kernel_ms."""

from benchmark.tracing import union_us


def read(ctx):
    busy = window = 0.0
    for req in ctx.requests:
        evs = ctx.events_in(req.start, req.end) if req.kind == "remap" \
            else []
        if evs:
            t1 = max(e for _, _, e in evs)
            busy += union_us([(s, e) for _, s, e in evs])
            window += t1 - evs[0][1]
    return 100.0 * (1.0 - busy / window) if window > 0 else None
