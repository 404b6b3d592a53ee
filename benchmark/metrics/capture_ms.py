"""capture_ms: the host milliseconds of the program's span
``advect.capture`` (the step loop's capture of a request's step as CUDA
graphs, ``advect.run_graphed``) in a trajectory request, the mean over the
requests recorded with detail on (the profiled ones; under detail a step
is captured as one graph a phase).  Moves particle_steps_per_s.  None
where the program records no spans (cellsearch_ms.recorder) or its
profiled requests count no captures (the counter ``advect.captures``: a
program without the span, a pathline, the eager loop); raises where they
count captures that no span timed."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_cellsearch_ms",
    Path(__file__).with_name("cellsearch_ms.py"))
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)

SPAN, COUNT = "advect.capture", "advect.captures"


def read(ctx):
    mgr = _cs.recorder()
    if mgr is None or not ctx.requests:
        return None
    reqs = _cs.profiled(mgr, ctx)
    counts = mgr.counters()
    captured = sum(counts.get(r, {}).get(COUNT, 0) for r in reqs)
    if not captured:
        return None
    spans = [s for s in mgr.spans() if s.request in reqs and s.name == SPAN]
    if not spans:
        raise RuntimeError(f"the profiled requests count {captured} "
                           f"{COUNT} but no span {SPAN}")
    return sum(s.host_ms for s in spans) / len(reqs)
