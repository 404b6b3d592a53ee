"""cellsearch_ms: the host milliseconds of the program's span
``cellsearch.query`` (``Field.calc_in_which_cells``, the seeds' start
cells) in a trajectory request, the mean over the requests recorded with
detail on (the profiled ones).  Moves particle_steps_per_s.

The readers of the program's spans and counters (this one,
step_host_us, step_ops_stream_us, window_misses_per_step,
readback_ms.remap and preprocess_s) take the recorder, the profiled
requests and their spans and counters from here.  They report nothing
where the program has no span recorder, and raise where it has one that
lacks what they read, so that a change to the program fails the metric
instead of leaving it out."""

import sys

TOP = {"streamline": "api.streamline", "pathline": "api.pathline",
       "remap": "api.remap"}


def recorder():
    """The program's span recorder (utils.timer's TimerManager) as the run
    loaded it, read from the loaded modules: the benchmark imports nothing
    of the program.  None where the program is not loaded or its
    TimerManager is the name-keyed one (start/stop) that kept no spans."""
    if "mops_tpu_torch" not in sys.modules:
        return None
    timer = sys.modules.get("mops_tpu_torch.utils.timer")
    mgr = getattr(timer, "TimerManager", None)
    if hasattr(mgr, "start") and not hasattr(mgr, "spans"):
        return None
    lacks = [a for a in ("instance", "spans", "counters")
             if not hasattr(mgr, a)]
    if lacks:
        raise RuntimeError("mops_tpu_torch.utils.timer.TimerManager lacks "
                           + ", ".join(lacks))
    return mgr.instance()


def profiled(mgr, ctx) -> set:
    """The ids of the cell's requests (api.<kind>) that the program
    recorded with detail on; raises where it recorded none."""
    top = TOP[ctx.requests[0].kind]
    reqs = {s.request for s in mgr.spans() if s.name == top and s.detail}
    if not reqs:
        raise RuntimeError(f"the program recorded no {top} with detail "
                           "under the profiler")
    return reqs


def spans_of(mgr, reqs, names) -> list:
    """The spans of ``reqs`` named in ``names``; raises where a request
    lacks one of the names."""
    spans = [s for s in mgr.spans() if s.request in reqs and s.name in names]
    for r in reqs:
        lacks = set(names) - {s.name for s in spans if s.request == r}
        if lacks:
            raise RuntimeError(f"request {r} has no span "
                               + ", ".join(sorted(lacks)))
    return spans


def steps_of(mgr, reqs) -> int:
    """The counter advect.steps summed over ``reqs``; raises where a
    request lacks it."""
    counts = mgr.counters()
    lacks = [r for r in reqs if "advect.steps" not in counts.get(r, {})]
    if lacks:
        raise RuntimeError(f"requests {sorted(lacks)} count no advect.steps")
    return sum(counts[r]["advect.steps"] for r in reqs)


def read(ctx):
    mgr = recorder()
    if mgr is None or not ctx.requests:
        return None
    reqs = profiled(mgr, ctx)
    spans = spans_of(mgr, reqs, ("cellsearch.query",))
    return sum(s.host_ms for s in spans) / len(reqs)
