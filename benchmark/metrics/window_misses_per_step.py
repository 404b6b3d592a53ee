"""window_misses_per_step: the lanes a step whose layer window missed, so
that the masked full-column repair stepped them again: the program's
counter ``advect.window_misses`` (the per-particle miss counts, summed
after the request) over ``advect.steps``, summed over the trajectory
requests recorded with detail on (the profiled ones).  Moves
particle_steps_per_s.  None where the program counts no misses (no
window) or records no spans (cellsearch_ms.recorder)."""

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
    steps = _cs.steps_of(mgr, reqs)
    counts = mgr.counters()
    misses = [counts[r]["advect.window_misses"] for r in reqs
              if "advect.window_misses" in counts[r]]
    return sum(misses) / steps if misses else None
