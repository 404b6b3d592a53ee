"""readback_ready_pct: the share of a trajectory request's read-back blocks
that the program copied into host blocks it had prepared and made resident
before the read-back began: its counter ``trajectory.readback_ready`` over
``trajectory.readback_blocks``, summed over the requests recorded with
detail on (the profiled ones), in %.  Moves particle_steps_per_s.  None
where the program records no spans (cellsearch_ms.recorder) or counts no
read-back blocks (a program that reads back into new memory alone)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_cellsearch_ms",
    Path(__file__).with_name("cellsearch_ms.py"))
_cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cs)

BLOCKS = "trajectory.readback_blocks"
READY = "trajectory.readback_ready"


def read(ctx):
    mgr = _cs.recorder()
    if mgr is None or not ctx.requests:
        return None
    reqs = _cs.profiled(mgr, ctx)
    counts = [mgr.counters().get(r, {}) for r in reqs]
    blocks = sum(c.get(BLOCKS, 0) for c in counts)
    if not blocks:
        return None
    return 100.0 * sum(c.get(READY, 0) for c in counts) / blocks
