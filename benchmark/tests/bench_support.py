"""Helpers of the benchmark's CPU tests: each cell cut to a size the CPU
runs in seconds, and one run of the harness there."""

from __future__ import annotations

import copy
import io
import json
import time

import torch

from benchmark import harness

CELLS = ["ec60-streamline-day", "l80-pathline-month", "ec60-remap-3601",
         "ec60-pathline-month"]
SEED = 2 ** 31 + 12345


def shrink(config: dict, mix: dict, precision: str = None):
    """A cell's configuration and mix at 2,000 cells and 10 levels, a
    21 x 21 seed grid (400 seeds, 64 followed) and 30 (streamline) or 72
    (pathline, a record every 12) steps, or a 181 x 91 image."""
    config = dict(config, n_cells=2000, n_vert_levels=10)
    if precision:
        config["precision"] = precision
    mix = copy.deepcopy(mix)
    if mix["request"] == "remap":
        mix["image"].update(width=181, height=91)
        return config, mix
    mix["seeds"]["sample_range"] = [21, 21]
    traj = mix["trajectory"]
    dt = int(traj["delta_t"])
    if mix["request"] == "pathline":
        traj.update(duration=dt * 72, record_t=dt * 12)
    else:
        traj.update(duration=dt * 30)
    mix["check"]["lanes_per_request"] = 64
    return config, mix


def run_cpu(cell: str, mesh_cache, seed: int = SEED, seconds: float = 0.5,
            trace: bool = False, precision: str = None) -> dict:
    """One harness run of ``cell`` on the CPU at the cut size, held to the
    cell's limits; returns the result line's object."""
    buf = io.StringIO()
    torch.manual_seed(0)
    res = harness.execute(
        cell, seed, seconds, trace, time.perf_counter(), device="cpu",
        mesh_cache=mesh_cache, out=buf,
        shrink=lambda c, m: shrink(c, m, precision))
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == res
    return res
