"""preprocess_s: the seconds of the program's own set-up work before the
first request recorded with detail on (the first profiled one): its spans
``mesh.from_raw``, ``mesh.to``, ``solution.preprocess`` (to the device's
completion: the larger of its host and stream time) and
``cellsearch.build``, a span nested in another of them counted once.
Moves setup_s.  None where the program records no spans
(cellsearch_ms.recorder)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_cellsearch_ms",
    Path(__file__).with_name("cellsearch_ms.py"))
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)

NAMES = ("mesh.from_raw", "mesh.to", "solution.preprocess",
         "cellsearch.build")


def read(ctx):
    mgr = _cs.recorder()
    if mgr is None or not ctx.requests:
        return None
    _cs.profiled(mgr, ctx)
    spans = mgr.spans()
    t0 = min(s.start_ns for s in spans if s.detail)
    by_id = {s.id: s for s in spans}

    def nested(s):
        up = by_id.get(s.parent)
        while up is not None:
            if up.name in NAMES:
                return True
            up = by_id.get(up.parent)
        return False
    mine = [s for s in spans
            if s.name in NAMES and s.end_ns <= t0 and not nested(s)]
    if not mine:
        raise RuntimeError("no set-up span (" + ", ".join(NAMES)
                           + ") before the first profiled request")
    return sum(max(s.host_ms, s.device_ms or 0.0) for s in mine) / 1e3
