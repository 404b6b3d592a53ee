"""remap_device_ms: the device's busy time an image (the union of its
activity within each traced remap request, profiler).  Moves
image_kernel_ms."""

from benchmark.tracing import union_us


def read(ctx):
    busy, n = 0.0, 0
    for req in ctx.requests:
        if req.kind != "remap":
            continue
        evs = ctx.events_in(req.start, req.end)
        if evs:
            busy += union_us([(s, min(e, req.end)) for _, s, e in evs])
            n += 1
    return busy / 1e3 / n if n else None
