"""graph_step_pct: the share of a trajectory request's steps that its step
loop ran by replaying a captured CUDA graph: the program's counter
``advect.graph_steps`` over ``advect.steps``, summed over the requests
recorded with detail on (the profiled ones), in %.  0 where they stepped
and replayed nothing (a pathline, the eager loop).  Moves
particle_steps_per_s.  None where the program records no spans
(cellsearch_ms.recorder) or counts no replays."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_cellsearch_ms",
    Path(__file__).with_name("cellsearch_ms.py"))
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)

GRAPH = "advect.graph_steps"


def read(ctx):
    mgr = _cs.recorder()
    if mgr is None or not ctx.requests:
        return None
    reqs = _cs.profiled(mgr, ctx)
    counts = mgr.counters()
    if not any(GRAPH in counts.get(r, {}) for r in reqs):
        return None
    graph = sum(counts.get(r, {}).get(GRAPH, 0) for r in reqs)
    return 100.0 * graph / _cs.steps_of(mgr, reqs)
