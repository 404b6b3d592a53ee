"""readback_ms.remap: the host milliseconds of the program's span
``remap.readback`` (the images copied to the host, after the host waited
for the device in ``remap.wait``) in an image request, the mean over the
requests recorded with detail on (the profiled ones).  Moves
image_kernel_ms.  None where the program records no spans
(cellsearch_ms.recorder)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_cellsearch_ms",
    Path(__file__).with_name("cellsearch_ms.py"))
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)


def read(ctx):
    mgr = _cs.recorder()
    if mgr is None or not ctx.requests:
        return None
    reqs = _cs.profiled(mgr, ctx)
    spans = _cs.spans_of(mgr, reqs, ("remap.readback",))
    return sum(s.host_ms for s in spans) / len(reqs)
