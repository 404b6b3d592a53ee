"""The traffic generator: one reader for every mix file in traffic/.

A mix is a closed loop of one client that sends a request, waits for its
reply and sends the next.  ``request`` names the API entry ("streamline",
"pathline" or "remap"); ``snapshots`` gives each snapshot's field
parameters (a [lo, hi] pair is drawn per run from the seed); a trajectory
mix gives its seed grid (``seeds``) and integration (``trajectory``), an
image mix its ``image``.  Job k of a run draws from (seed, k) alone, so no
two requests are the same and a run is reproduced by its seed.  Every job
of a trajectory mix has the same seed count, depths and steps: the seed
moves the grid in longitude within one grid spacing and shuffles the
depths, so every seed gives the same work.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from . import fields

EARTH_RADIUS = 6371010.0
ROOT = Path(__file__).resolve().parent
# Streams of a run's seed.
FIELD, JOB, CHECK = 1, 2, 3


def rng(seed: int, stream: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream, *map(int, keys)])


def load(name: str, root: Path = ROOT) -> dict:
    with open(Path(root) / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    if mix.get("request") not in ("streamline", "pathline", "remap"):
        raise ValueError(f"traffic {name}: unknown request {mix.get('request')}")
    return mix


def snapshot_params(mix: dict, seed: int) -> list:
    """Each snapshot's field parameters for a run of ``seed``."""
    return [fields.draw(spec, rng(seed, FIELD, i))
            for i, spec in enumerate(mix["snapshots"])]


def grid_axes(spec: dict):
    """The reference's seed grid axes (MPASOVisualizer.cpp:125-135): from
    min in steps of range / (n - 1) while below max, so n - 1 values."""
    def axis(lo, hi, n):
        step = (hi - lo) / float(n - 1)
        out, v = [], lo
        while v < hi:
            out.append(v)
            v += step
        return np.asarray(out), step
    lat, _ = axis(*spec["lat_range"], spec["sample_range"][0])
    lon, lon_step = axis(*spec["lon_range"], spec["sample_range"][1])
    return lat, lon, lon_step


@dataclasses.dataclass
class Job:
    """One trajectory request: the seeds (N, 3) float64 XYZ and their
    float32 depths."""

    index: int
    seeds: np.ndarray
    depths: np.ndarray

    @property
    def n(self) -> int:
        return len(self.seeds)


def trajectory_job(mix: dict, seed: int, k: int) -> Job:
    """Job k of a trajectory mix: the grid moved east by a draw within one
    grid spacing, the depths a shuffle of the linear profile."""
    spec = mix["seeds"]
    lat, lon, lon_step = grid_axes(spec)
    g = rng(seed, JOB, k)
    lon = lon + g.uniform(0.0, lon_step)
    la, lo = np.meshgrid(np.deg2rad(lat), np.deg2rad(lon), indexing="ij")
    la, lo = la.ravel(), lo.ravel()
    c = np.cos(la)
    seeds = EARTH_RADIUS * np.stack([c * np.cos(lo), c * np.sin(lo),
                                     np.sin(la)], axis=-1)
    d0, d1 = spec["depth_range"]
    depths = np.linspace(d0, d1, len(seeds)).astype(np.float32)
    return Job(k, seeds, g.permutation(depths))


def n_steps(traj: dict) -> int:
    return int(traj["duration"]) // int(traj["delta_t"])


def check_lanes(mix: dict, seed: int, k: int, n: int) -> np.ndarray:
    """The lanes of job k the reference follows: a sample drawn from
    (seed, k), sorted."""
    m = min(n, int(mix["check"]["lanes_per_request"]))
    return np.sort(rng(seed, CHECK, k).choice(n, size=m, replace=False))


def check_rows(mix: dict, seed: int, k: int) -> np.ndarray:
    """The image rows of request k the reference recomputes."""
    h = int(mix["image"]["height"])
    m = min(h, int(mix["check"]["rows_per_request"]))
    return np.sort(rng(seed, CHECK, k).choice(h, size=m, replace=False))
