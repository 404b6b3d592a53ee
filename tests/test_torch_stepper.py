"""The Stepper's one seam for the step (advect.make_stepper): the form is
picked once per run, K1-K4 by the back table and the window or the plain
step without use_kernel, and every step calls it through Stepper.step.  On
the CPU, where each wrapper runs its plain version, at L = 6 with windows
of W = 4 and a vertical flow fast enough that the window misses.  Imports
no jax."""

import dataclasses

import numpy as np
import pytest
import torch

import mops_tpu_torch as mtt
from mops_tpu_torch import advect
from mops_tpu_torch.kernels import stage_kernel as sk


@pytest.fixture(scope="module")
def case():
    mesh = mtt.synth.build_voronoi_mesh(500, n_layers=6)
    raw = mtt.synth.solid_body_fields(mesh, n_layers=6, w_scale=0.1)
    sol = mtt.preprocess(mesh, raw, device="cpu")
    # a back snapshot whose velocities and attributes both differ
    raw_b = {k: np.asarray(v) * (1.2 if k.startswith("velocity") else
                                 1.1 if k in ("temperature", "salinity")
                                 else 1.0) for k, v in raw.items()}
    back = mtt.preprocess(mesh, raw_b, device="cpu")
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cells = mtt.CellSearch(mesh).query(seeds)
    cells[[3, 30]] = -1                                  # dead lanes
    return mesh, sol, back, seeds, cells


def _bits(t):
    return t if t.dtype == torch.bool else t.view(torch.uint8)


def _direct(form, st, pos, dn, nv, vids, s, alphas):
    """The wrapper or plain version that ``form`` names, called directly
    with the stepper's tables and settings, as a StepOut."""
    L, W, dt, A = st.n_layers, st.n_window, st.dt, st.n_attrs
    tf, tb, eu = st.table, st.table_b, False                 # RK4
    if form == "k1":
        return advect.StepOut(*sk.fused_streamline_step(
            pos, dn, nv, vids, tf, L, dt, eu))
    if form == "k2":
        out = sk.fused_pathline_step(pos, dn, nv, vids, tf, tb, L, dt, alphas,
                                     eu, A)
        return advect.StepOut(*out[:4], attr=out[4])
    if form == "k3":
        return advect.StepOut(*sk.fused_window_streamline_step(
            pos, dn, nv, vids, s, tf, st.rise, L, W, dt, eu))
    if form == "k4":
        return advect.StepOut(*sk.fused_window_pathline_step(
            pos, dn, nv, vids, s, tf, tb, st.rise, st.rise_b, L, W, dt,
            alphas, eu, A))
    if form == "plain streamline":
        return advect.StepOut(*sk.fused_streamline_step_plain(
            pos, dn, nv, vids, tf, L, dt, eu, True))
    out = sk.fused_pathline_step_plain(pos, dn, nv, vids, tf, tb, L, dt,
                                       alphas, eu, A, True)
    return advect.StepOut(*out[:4], attr=out[4])


@pytest.mark.parametrize("form", ["k1", "k2", "k3", "k4", "plain streamline",
                                  "plain pathline"])
def test_stepper_resolves_the_step_once(case, form, monkeypatch):
    """st.kernel is the kernel LAST_RESOLVED records; the step that advance
    runs gives, bit for bit, what the wrapper or plain version it names
    gives called directly on the same inputs (the pathline's attributes
    and the window's layer, miss and clamp included, None where the form
    has none); no launch counter moves on the CPU."""
    mesh, sol, back, seeds, cells = case
    monkeypatch.setattr(advect, "WINDOW_LAYERS", 4)
    pathline = form in ("k2", "k4", "plain pathline")
    kernel = None if form.startswith("plain") else form
    kw = dict(back=back if pathline else None, use_kernel=kernel is not None,
              use_window=form in ("k3", "k4"))
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 2, record_t=1200,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32))
    before = sk.launch_counts()
    advect.run_advection(mesh, sol, seeds, cells, cfg, device="cpu", **kw)
    st, sols = advect.prepare(mesh, sol, kw.pop("back"), cfg, torch.float64,
                              torch.device("cpu"), **kw)
    assert st.kernel == advect.LAST_RESOLVED["kernel"] == kernel
    assert st.n_attrs == (2 if pathline else 0)
    calls = []

    def spy(*args):
        out = st.step(*args)
        calls.append((args, out))
        return out
    p = advect.start_particles(st, sols, seeds, cells,
                               cfg.effective_depths(len(seeds)),
                               cfg.n_records)
    for i in range(cfg.n_steps):
        advect.advance(dataclasses.replace(st, step=spy), p, i)
    args, got = calls[-1]                      # step 1: relocated, alphas > 0
    want = _direct(form, st, *args)
    for name in advect.StepOut._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(_bits(a), _bits(b)), name
    assert (got.attr is not None) == pathline
    assert (got.layer is not None) == (form in ("k3", "k4"))
    if form in ("k3", "k4"):
        assert bool(got.miss.any())
    assert sk.launch_counts() == before
