"""metrics/readback_ready_pct: nothing where the program counts no
read-back blocks, and the ready share of the profiled requests' blocks
where it does, from a stand-in recorder and from the program's own."""

import sys
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from benchmark import tracing


def _read(ctx):
    return tracing.load_reader("readback_ready_pct")(ctx)


def _ctx():
    return tracing.Context([], [], [tracing.Request(0, "streamline", 0, 1,
                                                    steps=3)], {}, {})


def _stand_in(spans, counts):
    """A span recorder holding ``spans`` (name, request, detail) and the
    requests' ``counts``."""
    class Recorder:
        @classmethod
        def instance(cls):
            return cls()

        def spans(self):
            return [types.SimpleNamespace(name=n, request=r, detail=d)
                    for n, r, d in spans]

        def counters(self):
            return counts
    return Recorder


def _install(monkeypatch, manager):
    monkeypatch.setitem(sys.modules, "mops_tpu_torch",
                        types.ModuleType("mops_tpu_torch"))
    monkeypatch.setitem(sys.modules, "mops_tpu_torch.utils.timer",
                        types.SimpleNamespace(TimerManager=manager))


@pytest.mark.parametrize("counts", [{0: {"advect.graph_steps": 0}}, {},
                                    {0: {"trajectory.readback_blocks": 0,
                                         "trajectory.readback_ready": 0}}],
                         ids=["other-counters", "no-counters", "no-blocks"])
def test_none_without_read_back_blocks(counts, monkeypatch):
    """A program whose profiled requests count no read-back block (the
    parent's, or a run that read nothing back) gives no reading."""
    _install(monkeypatch, _stand_in([("api.streamline", 0, True)], counts))
    assert _read(_ctx()) is None


def test_none_before_the_span_recorder(monkeypatch):
    _install(monkeypatch, type("TimerManager", (), {"start": None,
                                                    "stop": None}))
    assert _read(_ctx()) is None


def test_ready_share_of_the_profiled_requests(monkeypatch):
    """Ready blocks over read-back blocks, summed over the profiled
    requests; an unprofiled request is left out."""
    spans = [("api.streamline", 0, True), ("api.streamline", 1, True),
             ("api.streamline", 2, False)]
    counts = {0: {"trajectory.readback_blocks": 2,
                  "trajectory.readback_ready": 2},
              1: {"trajectory.readback_blocks": 4,
                  "trajectory.readback_ready": 1},
              2: {"trajectory.readback_blocks": 4,
                  "trajectory.readback_ready": 0}}
    _install(monkeypatch, _stand_in(spans, counts))
    assert _read(_ctx()) == 50.0


def test_reads_the_programs_counters():
    """The program's finalize into prepared host blocks, profiled, reads
    100; into new memory alone (records on the host), nothing."""
    from torch.profiler import ProfilerActivity, profile
    import mops_tpu_torch as mtt
    from mops_tpu_torch.utils.timer import TimerManager
    mgr = TimerManager.instance()
    mgr.reset()
    rng = np.random.default_rng(1)
    seeds = rng.normal(size=(6, 3))
    pts = torch.from_numpy(rng.normal(size=(6, 4, 3)))
    cfg = mtt.TrajectorySettings(delta_t=60, record_t=60,
                                 simulation_duration=240)
    with profile(activities=[ProfilerActivity.CPU]):
        with mgr.request("api.streamline"):
            mtt.finalize_trajectories(seeds, pts, pts, cfg)
    assert _read(_ctx()) is None
    host = Future()
    host.set_result(mtt.trajectory.host_blocks(6, 4, False))
    with profile(activities=[ProfilerActivity.CPU]):
        with mgr.request("api.streamline"):
            mtt.finalize_trajectories(seeds, pts, pts, cfg, host=host)
    assert _read(_ctx()) == 100.0
