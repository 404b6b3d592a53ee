"""``correct`` separates: the program passes each cell's limits, the control
(the reference in the precision below the configuration's: float32 with
TF32 weighted sums) fails them, and a run whose timed path is broken
underneath comes out not correct, once for each fault the cell can have.
All at the CPU size of bench_support.shrink, the card's look skipped."""

import dataclasses

import numpy as np
import pytest
import torch

import bench_support
from benchmark import calibrate, check

TRAJECTORY = [c for c in bench_support.CELLS if "remap" not in c]


@pytest.mark.parametrize("cell", bench_support.CELLS)
def test_control_fails_and_program_passes(cell, tmp_path):
    limits = check.load_limits(cell)
    r = calibrate.readings(cell, [bench_support.SEED, 7], 2, device="cpu",
                           shrink=bench_support.shrink, mesh_cache=tmp_path)
    for row in r["program"]:
        assert all(row[k] <= v for k, v in limits.items()), (row, limits)
    for row in r["control"]:
        assert any(row[k] > v for k, v in limits.items()), (row, limits)


def test_sound_run_is_correct(tmp_path):
    res = bench_support.run_cpu("ec60-streamline-day", tmp_path)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"


# -- faults in the trajectory cells ------------------------------------------

def state_unchanged(monkeypatch):
    """Each step returns the particles as they were."""
    from mops_tpu_torch import advect
    monkeypatch.setattr(advect, "advance", lambda st, p, i: None)


def half_the_batch(monkeypatch):
    """Only the first half of the particles is advected; the rest keep
    their empty records."""
    from mops_tpu_torch import advect
    real = advect.run_advection

    def half(mesh, front, seeds, cells, settings, **kw):
        n = len(seeds)
        cut = dataclasses.replace(
            settings, particle_depths=settings.effective_depths(n)[:n // 2])
        raw = real(mesh, front, seeds[:n // 2], cells[:n // 2], cut, **kw)

        def pad(t):
            if t is None or t.ndim == 0 or t.shape[0] != n // 2:
                return t
            return torch.cat([t, torch.zeros((n - n // 2,) + t.shape[1:],
                                             dtype=t.dtype)])
        return dataclasses.replace(raw, **{
            f.name: pad(getattr(raw, f.name))
            for f in dataclasses.fields(raw)})
    monkeypatch.setattr(advect, "run_advection", half)


def answer_altered(monkeypatch):
    """Each line's velocities come out 1 % off where they are made."""
    from mops_tpu_torch import trajectory
    real = trajectory.finalize_trajectories

    def altered(*args, **kwargs):
        lines = real(*args, **kwargs)
        for line in lines:
            line.velocity = line.velocity * 1.01
        return lines
    monkeypatch.setattr(trajectory, "finalize_trajectories", altered)


def few_lines_velocity(monkeypatch, every):
    """One line in ``every`` comes out with its velocities 1 % off: a
    fault on a few lanes, as a broken repair list would make."""
    from mops_tpu_torch import trajectory
    real = trajectory.finalize_trajectories

    def altered(*args, **kwargs):
        lines = real(*args, **kwargs)
        for line in lines[::every]:
            line.velocity = line.velocity * 1.01
        return lines
    monkeypatch.setattr(trajectory, "finalize_trajectories", altered)


def few_lines_points(monkeypatch, every):
    """One line in ``every`` comes out with its recorded points 1 km off
    (its velocities as they were)."""
    from mops_tpu_torch import trajectory
    real = trajectory.finalize_trajectories

    def altered(*args, **kwargs):
        lines = real(*args, **kwargs)
        for line in lines[::every]:
            pts = np.array(line.points, copy=True)
            pts[1:, 0] += 1000.0
            line.points = pts
        return lines
    monkeypatch.setattr(trajectory, "finalize_trajectories", altered)


@pytest.mark.parametrize("cell", TRAJECTORY)
@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   answer_altered, few_lines_velocity,
                                   few_lines_points])
def test_trajectory_fault_is_not_correct(cell, fault, tmp_path, monkeypatch):
    if fault in (few_lines_velocity, few_lines_points):
        # a share of the lines past the cell's parted_first_pct limit and
        # under the quarter a 75th percentile needs: a sixteenth where the
        # limit is 1 %, a sixth where it is 10 %
        limit = check.load_limits(cell)["parted_first_pct"]
        fault(monkeypatch, 16 if limit <= 4.0 else 6)
    else:
        fault(monkeypatch)
    res = bench_support.run_cpu(cell, tmp_path)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


# -- faults in the image cell --------------------------------------------------

def stale_snapshot(monkeypatch):
    """Activating the next snapshot changes nothing: the image is the last
    one's state."""
    from mops_tpu_torch import api
    monkeypatch.setattr(api.MOPSApp, "active_attribute",
                        lambda self, id1, id2=None: None)


def half_the_pixels(monkeypatch):
    """The second half of each image's pixels is left out (NaN)."""
    from mops_tpu_torch import remap
    real = remap.run_remapping

    def half(field, cfg, **kw):
        imgs = real(field, cfg, **kw)
        for img in imgs:
            flat = img.reshape(-1, img.shape[-1])
            flat[flat.shape[0] // 2:] = np.nan
        return imgs
    monkeypatch.setattr(remap, "run_remapping", half)


def image_altered(monkeypatch):
    """Each image's values come out 1 % off where they are made."""
    from mops_tpu_torch import remap
    real = remap.run_remapping
    monkeypatch.setattr(remap, "run_remapping",
                        lambda field, cfg, **kw: [i * 1.01 for i in
                                                  real(field, cfg, **kw)])


def few_pixels_masked(monkeypatch):
    """One pixel in 64 of each image comes out NaN: a mask fault on far
    fewer than a quarter of the pixels."""
    from mops_tpu_torch import remap
    real = remap.run_remapping

    def masked(field, cfg, **kw):
        imgs = real(field, cfg, **kw)
        for img in imgs:
            img.reshape(-1, img.shape[-1])[::64] = np.nan
        return imgs
    monkeypatch.setattr(remap, "run_remapping", masked)


@pytest.mark.parametrize("fault", [stale_snapshot, half_the_pixels,
                                   image_altered, few_pixels_masked])
def test_image_fault_is_not_correct(fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    # a stale snapshot shows from the window's second request on
    seconds = 5.0 if fault is stale_snapshot else 0.2
    res = bench_support.run_cpu("ec60-remap-3601", tmp_path, seconds=seconds)
    assert res["attempted"] >= (2 if fault is stale_snapshot else 1)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
