"""step_ops_stream_us: the stream microseconds a step of the step loop's
phases other than the step kernel (the program's spans
``advect.relocate``, ``advect.gather``, ``advect.update`` and
``advect.record``: CUDA events at each phase's ends, launch gaps
included), over the counter ``advect.steps``, summed over the trajectory
requests recorded with detail on (the profiled ones).  On the CPU, where
a phase has no events, its host time.  Moves particle_steps_per_s.  None
where the program records no spans (cellsearch_ms.recorder)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_cellsearch_ms",
    Path(__file__).with_name("cellsearch_ms.py"))
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)

OPS = ("advect.relocate", "advect.gather", "advect.update", "advect.record")


def read(ctx):
    mgr = _cs.recorder()
    if mgr is None or not ctx.requests:
        return None
    reqs = _cs.profiled(mgr, ctx)
    phases = _cs.spans_of(mgr, reqs, OPS)
    return 1e3 * sum(s.ms for s in phases) / _cs.steps_of(mgr, reqs)
