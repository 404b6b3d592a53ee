"""The graphed step loop (advect.run_graphed) on the CPU, where a captured
step is run again at each replay: its lines, records and state equal the
eager loop's bit for bit, the record phase writes the schedule's slots
from the replayed step's fixed rows, the loop's plan of step kinds
reproduces the schedule, and the kernels' launches held during a capture
count once a replay.  The CUDA graphs themselves are tested on the card
(tests/test_torch_cuda.py).  Imports no jax."""

import dataclasses

import numpy as np
import pytest
import torch

import mops_tpu_torch as mtt
from mops_tpu_torch import advect
from mops_tpu_torch.kernels import stage_kernel as sk
from mops_tpu_torch.utils.timer import TimerManager

def _replayed(run):
    """run() and the steps its advection replayed (advect.graph_steps)."""
    mgr = TimerManager.instance()
    before = mgr.counter("advect.graph_steps")
    out = run()
    return out, mgr.counter("advect.graph_steps") - before


FIELDS = ("points", "velocities", "final_position", "final_depth",
          "final_cell", "alive", "window_misses", "window_clamp_misses")


@pytest.fixture(scope="module")
def case():
    mesh = mtt.synth.build_voronoi_mesh(500, n_layers=6)
    # vertical flow fast enough that the window of 4 layers misses
    raw = mtt.synth.solid_body_fields(mesh, n_layers=6, w_scale=0.1)
    sol = mtt.preprocess(mesh, raw, device="cpu")
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cells = mtt.CellSearch(mesh).query(seeds)
    cells[[3, 30]] = -1                                  # dead lanes
    return mesh, sol, seeds, cells


def _settings(seeds, fail_mode="ZERO", direction="FORWARD", record_t=1200,
              delta_t=600, duration=600 * 12):
    return mtt.TrajectorySettings(
        delta_t=delta_t, simulation_duration=duration, record_t=record_t,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32),
        fail_mode=getattr(mtt.FailMode, fail_mode),
        direction=getattr(mtt.CalcDirection, direction))


def _bits(t):
    return t if t.dtype == torch.bool else t.view(torch.uint8)


def _assert_same(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        assert torch.equal(_bits(x), _bits(y)), name


# schedules of the step-kind and record tests: (delta_t, duration, record_t)
SCHEDULES = {
    "day": (120, 86400, 360),          # the streamline-day mix
    "month": (600, 2592000, 21600),    # the pathline-month mix
    "odd": (120, 86400, 500),          # record_t not a multiple of delta_t
}


@pytest.mark.parametrize("window", [True, False], ids=["k3", "k1"])
@pytest.mark.parametrize("fail_mode", ["ZERO", "FREEZE"])
@pytest.mark.parametrize("direction", ["FORWARD", "BACKWARD"])
def test_graphed_run_equals_eager_bit_for_bit(case, window, fail_mode,
                                              direction, monkeypatch):
    """run_advection with graph=True (replays, the CPU's rerun) gives the
    eager loop's records, final state and window misses bit for bit, and
    counts the steps it replayed."""
    mesh, sol, seeds, cells = case
    cfg = _settings(seeds, fail_mode, direction)
    monkeypatch.setattr(advect, "WINDOW_LAYERS", 4)
    runs = {}
    for graph in (False, True):
        runs[graph], replayed = _replayed(lambda: advect.run_advection(
            mesh, sol, seeds, cells, cfg, device="cpu", use_window=window,
            graph=graph))
        assert replayed == (cfg.n_steps - advect.GRAPH_WARM_STEPS
                            if graph else 0)
    _assert_same(runs[False], runs[True])
    assert (runs[True].window_misses is not None) == window


@pytest.mark.parametrize("schedule", ["pathline-style", "odd"])
def test_record_from_fixed_rows_equals_slice_form(case, schedule,
                                                  monkeypatch):
    """The record phase after a replay writes p.pos and the step's fixed
    value rows into record_schedule's slots, as advance writes them: the
    points and velocities equal the eager loop's, including a schedule
    whose slots run past R (the slots beyond are dropped)."""
    mesh, sol, seeds, cells = case
    if schedule == "odd":
        cfg = _settings(seeds, delta_t=120, duration=120 * 40, record_t=500)
    else:
        cfg = _settings(seeds, delta_t=120, duration=120 * 50, record_t=250)
    pathline_style = schedule != "odd"
    monkeypatch.setattr(advect, "WINDOW_LAYERS", 4)
    st, sols = advect.prepare(mesh, sol, None, cfg, torch.float64,
                              torch.device("cpu"), use_window=True)
    flags, slots = advect.record_schedule(cfg, pathline_style)
    st = dataclasses.replace(st, flags=flags, slots=slots)
    if pathline_style:       # 25 records fall due, R = 24: the last dropped
        due = (np.arange(cfg.n_steps) + 1) % (cfg.record_t // cfg.delta_t)
        assert (due == 0).sum() > cfg.n_records == flags.sum()
    assert flags[advect.GRAPH_WARM_STEPS:].any()

    def start():
        return advect.start_particles(st, sols, seeds, cells,
                                      cfg.effective_depths(len(seeds)),
                                      cfg.n_records)

    eager = start()
    for i in range(cfg.n_steps):
        advect.advance(st, eager, i)
    graphed = start()
    replayed = advect.run_graphed(st, graphed)
    assert replayed == cfg.n_steps - advect.GRAPH_WARM_STEPS
    _assert_same(eager.raw(), graphed.raw())
    last = int(slots[flags][-1])
    assert torch.count_nonzero(graphed.vels[:, last]) > 0


@pytest.mark.parametrize("pathline", [False, True],
                         ids=["streamline", "pathline"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_step_plan_reproduces_the_schedule(schedule, pathline):
    """The graphed loop's step kinds: the warm-up steps (step 0 among
    them) eager, then a record step exactly where the schedule records
    and a plain step elsewhere; the slots the record steps write, in
    order, continue the warm-up's and stay below R."""
    delta_t, duration, record_t = SCHEDULES[schedule]
    cfg = mtt.TrajectorySettings(delta_t=delta_t,
                                 simulation_duration=duration,
                                 record_t=record_t)
    is_first, flags, slots, _, _ = advect.advection_schedule(cfg, pathline)
    kinds = advect.step_plan(is_first, flags)
    warm = advect.GRAPH_WARM_STEPS
    assert len(kinds) == cfg.n_steps
    assert kinds[:warm] == ["eager"] * warm
    assert all(k == "eager" for k, first in zip(kinds, is_first) if first)
    assert [k == "record" for k in kinds[warm:]] == list(flags[warm:])
    assert "plain" in kinds
    recorded = [int(s) for k, s, f in zip(kinds, slots, flags)
                if k == "record" or (k == "eager" and f)]
    assert recorded == list(range(len(recorded)))
    assert len(recorded) <= cfg.n_records
    assert recorded == list(slots[flags])


def test_resolve_graph_applies_to_one_device_kernel_streamlines(case):
    mesh, sol, seeds, _ = case
    cfg = _settings(seeds)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    st, _ = advect.prepare(mesh, sol, None, cfg, torch.float64, cpu)
    path, _ = advect.prepare(mesh, sol, sol, cfg, torch.float64, cpu)
    plain, _ = advect.prepare(mesh, sol, None, cfg, torch.float64, cpu,
                              use_kernel=False)
    assert advect.resolve_graph(None, st, [cuda])
    assert not advect.resolve_graph(None, st, [cpu])
    assert not advect.resolve_graph(None, st, [cuda, cuda])
    assert not advect.resolve_graph(None, path, [cuda])
    assert not advect.resolve_graph(None, plain, [cuda])
    assert not advect.resolve_graph(False, st, [cuda])
    assert advect.resolve_graph(True, st, [cpu])
    for stepper, devices in ((path, [cpu]), (st, [cpu, cpu]),
                             (plain, [cpu])):
        with pytest.raises(ValueError):
            advect.resolve_graph(True, stepper, devices)


def test_pathline_and_several_devices_keep_the_eager_loop(case, monkeypatch):
    mesh, sol, seeds, cells = case
    cfg = _settings(seeds)
    monkeypatch.setattr(advect, "WINDOW_LAYERS", 4)
    with pytest.raises(ValueError):
        advect.run_advection(mesh, sol, seeds, cells, cfg, back=sol,
                             device="cpu", graph=True)
    one = advect.run_advection(mesh, sol, seeds, cells, cfg, device="cpu",
                               graph=True, use_window=True)
    two, replayed = _replayed(lambda: advect.run_advection(
        mesh, sol, seeds, cells, cfg, use_window=True,
        devices=["cpu", "cpu"]))
    assert replayed == 0
    _assert_same(one, two)


def test_held_launches_count_once_a_replay():
    """Launches inside held_counts are tallied, not counted; count_launches
    counts the tally the given number of times, double launches under
    kernels.f64_launches.<key> as well."""
    mgr = TimerManager.instance()
    sk.reset_counts()
    with sk.held_counts() as tally:
        sk.count_launch("k3", torch.float64)
        sk.count_launch("k3 repair", torch.float64)
    assert sk.launch_counts()["k3"] == 0
    assert tally == {sk.LAUNCHES + "k3": 1, sk.LAUNCHES + "k3 repair": 1,
                     sk.F64_LAUNCHES + "k3": 1,
                     sk.F64_LAUNCHES + "k3 repair": 1}
    sk.count_launches(tally, 7)
    sk.count_launch("k3", torch.float32)
    assert sk.launch_counts()["k3"] == 8
    assert sk.launch_counts()["k3 repair"] == 7
    assert mgr.counter(sk.F64_LAUNCHES + "k3") == 7
    sk.reset_counts()
