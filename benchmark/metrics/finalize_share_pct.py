"""finalize_share_pct: the share of a trajectory request's time that the
host spends in ``trajectory.finalize_trajectories`` (the benchmark's span
around it), summed over the traced requests.  Moves particle_steps_per_s."""


def read(ctx):
    fin = total = 0.0
    for req in ctx.requests:
        spans = ctx.spans_of(req.index, "finalize")
        if req.kind in ("streamline", "pathline") and spans:
            fin += sum(s.end - s.start for s in spans)
            total += req.end - req.start
    return 100.0 * fin / total if total > 0 else None
