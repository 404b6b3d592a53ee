"""The numbers that decide ``correct``: the program's answers against the
reference's, each held to its limit in limits/<cell>.json (the limits file
names the numbers a cell compares; the others are printed only).

A trajectory request is judged on a sample of its lines (traffic.
check_lanes), by the relative error of each record's velocity (and
attributes) against the reference's: ``vel_err_first`` and
``attr_err_first`` take the first record (the first hour or steps, before
float32 and float64 lines part), ``vel_err_p50`` each lane's median over
all its records; each is a percentile over the lanes (75th, or 50th for
vel_err_p50), and a run's number the largest over its requests, so a wrong
request, or a quarter of the lanes of one, fails it.  ``parted_first_pct``
counts lane by lane: the share of the sampled lanes whose first record has
departed (a velocity or attribute error past 1e-4, a position gap past
100 m, or a number that is not finite), so a fault on a few lanes of a
request fails it too.  ``vel_err``, ``vel_err_rec`` (the median lane at the
first, a quarter, half, three quarters and the last record),
``pos_gap_first_m``, ``pos_gap_m``, ``far_lanes_pct`` and ``parted_pct``
(lanes whose velocity error passed 1e-4 by a quarter, half and all of the
records) show how far the lines part later.  An image request is judged on
a sample of its rows (traffic.check_rows): per pixel, infinite where the
NaN masks differ, 0 where both are NaN, else the largest relative error of
its channels (``image_err``, the 75th percentile over the pixels, the
largest over requests); ``pixels_parted_pct`` counts pixel by pixel: the
share of pixels whose error passes 1e-4 or whose NaN masks differ, so a
fault on a few pixels fails it too; ``nan_mismatch_pct``, the share whose
masks differ, is printed (float32 geometry flips a pixel's mask now and
then, as it does for the control, so it cannot separate them alone).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
V_FLOOR = 1e-3         # m/s: velocities below it are compared absolutely
A_FLOOR = 1e-3         # attribute units likewise
Q = 75                 # the percentile over lanes or pixels
PART_ERR = 1e-4        # a relative error past which a lane has departed
PART_GAP_M = 100.0     # m: a position gap past which a lane has departed


def _rel(got, want, floor):
    """|got - want| / max(|want|, floor) of (..., 3) vectors, by norm."""
    return np.linalg.norm(got - want, axis=-1) / np.maximum(
        np.linalg.norm(want, axis=-1), floor)


def trajectory_numbers(got: dict, want: dict) -> dict:
    """Numbers of one request's sampled lines: ``got`` and ``want`` hold
    "points", "velocity" (and "attrs") arrays (S, R + 1, 3)."""
    n_rec = want["points"].shape[1] - 1
    rel = _rel(got["velocity"][:, :n_rec], want["velocity"][:, :n_rec],
               V_FLOOR)                                        # (S, R)
    gap = np.linalg.norm(got["points"] - want["points"], axis=-1)
    marks = sorted({0, n_rec // 4, n_rec // 2, 3 * n_rec // 4, n_rec - 1})
    # points[:, 0] is the seed: the first record is points[:, 1]
    departed = ~(rel[:, 0] <= PART_ERR) | ~(gap[:, 1] <= PART_GAP_M)
    out = {"vel_err": _q(np.median(rel, axis=1)),
           "vel_err_first": _q(rel[:, 0]),
           "vel_err_p50": float(np.percentile(np.median(rel, axis=1), 50,
                                              method="higher")),
           "vel_err_rec": [float(np.percentile(rel[:, r], 50,
                                               method="higher"))
                           for r in marks],
           "pos_gap_first_m": float(np.max(gap[:, 1])),
           "pos_gap_m": _q(gap.max(axis=1)),
           "far_lanes_pct": float(100.0 * np.mean(gap.max(axis=1) > 1000.0)),
           "parted_pct": [float(100.0 * np.mean((rel[:, :r + 1] > PART_ERR)
                                                .any(axis=1)))
                          for r in sorted({0, n_rec // 4, n_rec // 2,
                                           n_rec - 1})]}
    if "attrs" in want:
        g, w = got["attrs"][:, :n_rec, :2], want["attrs"][:, :n_rec, :2]
        err = (np.abs(g - w) / np.maximum(np.abs(w), A_FLOOR)).max(axis=-1)
        out["attr_err"] = _q(np.median(err, axis=1))
        out["attr_err_first"] = _q(err[:, 0])
        departed |= ~(err[:, 0] <= PART_ERR)
    out["parted_first_pct"] = float(100.0 * np.mean(departed))
    for key, value in out.items():
        if isinstance(value, float) and not np.isfinite(value):
            out[key] = float("inf")
        elif isinstance(value, list):
            out[key] = [v if np.isfinite(v) else float("inf") for v in value]
    return out


def _q(values) -> float:
    """The Q-th percentile, an element of ``values`` (no interpolation)."""
    return float(np.percentile(values, Q, method="higher"))


def image_numbers(got: list, want: list) -> dict:
    """Numbers of one image request's sampled rows: ``got`` and ``want``
    are [velocity (n, W, 3), attribute groups (n, W, 3g) or None].  The
    velocity image's channels (east, north, speed) are held to its largest
    speed, each attribute channel to its own largest magnitude."""
    errs, mismatch = [], 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        nan_g, nan_w = np.isnan(g).any(-1), np.isnan(w).any(-1)
        scale = np.nanmax(np.abs(w).reshape(-1, w.shape[-1]), axis=0) \
            if (~nan_w).any() else np.zeros(w.shape[-1])
        if i == 0:
            scale = np.full_like(scale, scale.max())
        d = np.abs(np.nan_to_num(g) - np.nan_to_num(w))
        rel = np.where(scale > 0, d / np.where(scale > 0, scale, 1.0), 0.0)
        e = np.where(nan_g != nan_w, np.inf,
                     np.where(nan_w, 0.0, rel.max(axis=-1)))
        errs.append(e.ravel())
        mismatch = max(mismatch, float(100.0 * np.mean(nan_g != nan_w)))
    errs = np.concatenate(errs)
    return {"image_err": _q(errs),
            "pixels_parted_pct": float(100.0 * np.mean(~(errs <= PART_ERR))),
            "nan_mismatch_pct": mismatch}


def worst(per_request: list) -> dict:
    """A run's numbers: the largest of each over its requests."""
    keys = per_request[0].keys() if per_request else []
    return {k: (np.max([r[k] for r in per_request], axis=0).tolist()
                if isinstance(per_request[0][k], list)
                else max(r[k] for r in per_request)) for k in keys}


def load_limits(cell: str, root: Path = ROOT) -> dict:
    """{number: limit} of a cell (limits/<cell>.json); the file also keeps
    the readings each limit was set from."""
    with open(Path(root) / "limits" / f"{cell}.json") as f:
        spec = json.load(f)
    return {k: float(v["limit"]) for k, v in spec["limits"].items()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: {value, limit}});
    a number the run did not produce fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("inf"))
        table[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, table
