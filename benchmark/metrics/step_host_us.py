"""step_host_us: the host microseconds of the program's span
``advect.loop`` (the particles' start and the step loop of
``advect.run_advection``) over the counter ``advect.steps``, summed over
the trajectory requests recorded with detail on (the profiled ones).
Moves particle_steps_per_s.  None where the program records no spans
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
    loops = _cs.spans_of(mgr, reqs, ("advect.loop",))
    loop_ms = sum(s.host_ms for s in loops)
    return 1e3 * loop_ms / _cs.steps_of(mgr, reqs)
