"""f64_launch_pct: the share of the step kernels' launches that ran their
double instance: the program's counters ``kernels.f64_launches.<key>``
over ``kernels.launches.<key>``, summed over the requests recorded with
detail on (the profiled ones), in %.  Moves particle_steps_per_s.  None
where those requests counted no double launch (the plain path, the float
instances, or a program that does not count them) or the program records
no spans (cellsearch_ms.recorder)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_cellsearch_ms",
    Path(__file__).with_name("cellsearch_ms.py"))
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)

LAUNCHES = "kernels.launches."
F64 = "kernels.f64_launches."


def read(ctx):
    mgr = _cs.recorder()
    if mgr is None or not ctx.requests:
        return None
    reqs = _cs.profiled(mgr, ctx)
    counts = mgr.counters()
    launches = f64 = 0
    for r in reqs:
        for name, n in counts.get(r, {}).items():
            if name.startswith(LAUNCHES):
                launches += n
            elif name.startswith(F64):
                f64 += n
    return 100.0 * f64 / launches if f64 else None
