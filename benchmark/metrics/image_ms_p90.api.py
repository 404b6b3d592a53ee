"""image_ms_p90.api: the 90th percentile of the times of all the window's
images, from ``MOPS_ActiveAttribute`` of the next snapshot to the arrays on
the host (host clock; the traced images among them).  Too unsteady from run
to run to bound end to end, so it stands beside image_kernel_ms, which it
moves."""

import numpy as np


def read(ctx):
    if not ctx.request_s or not ctx.requests \
            or any(r.kind != "remap" for r in ctx.requests):
        return None
    return float(np.percentile(np.asarray(ctx.request_s) * 1e3, 90))
