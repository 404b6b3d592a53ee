"""pixels_per_s.api: the pixels of every image of the window over its seconds
(host clock; an image runs from ``MOPS_ActiveAttribute`` of the next
snapshot to the arrays on the host, the traced images among them).  Too
unsteady from run to run, with the host's read-back in it, to bound end to
end, so it stands beside image_kernel_ms, which it moves."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.requests \
            or any(r.kind != "remap" for r in ctx.requests):
        return None
    return ctx.work / ctx.window_s
