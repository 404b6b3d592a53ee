"""The per-layer metrics that read the program's own spans and counters
(metrics/cellsearch_ms, step_host_us, step_ops_stream_us,
window_misses_per_step, readback_ms.remap, preprocess_s): a traced run of
each cell on the CPU at the cut size reports every one of the cell's,
finite, and none outside its cells."""

import math
import sys

import pytest

from benchmark import harness
from benchmark.tests import bench_support

PROGRAM = {"cellsearch_ms", "step_host_us", "step_ops_stream_us",
           "window_misses_per_step", "readback_ms.remap", "preprocess_s"}


@pytest.mark.parametrize("cell", bench_support.CELLS)
def test_traced_run_reports_the_program_metrics(cell, tmp_path, monkeypatch):
    from mops_tpu_torch import advect
    # the window path for use_window=None, as on the card
    resolve = advect.resolve_window
    monkeypatch.setattr(
        advect, "resolve_window", lambda use_kernel, use_window, *a:
        resolve(use_kernel, True if use_window is None else use_window, *a))
    res = bench_support.run_cpu(cell, tmp_path, trace=True)
    assert res["correct"]
    spec = harness.load_spec()
    want = {m["name"] for m in harness.metrics_of(spec, "per_layer", cell)
            } & PROGRAM
    assert want == ({"readback_ms.remap", "preprocess_s"}
                    if cell == "ec60-remap-3601"
                    else PROGRAM - {"readback_ms.remap"})
    got = res["metrics"]
    for name in want:
        assert name in got, name
        value = got[name]["value"]
        assert value is not None and math.isfinite(value), (name, value)
        assert value >= 0, (name, value)
    assert got["preprocess_s"]["value"] > 0
    if cell != "ec60-remap-3601":
        assert got["step_host_us"]["value"] > got["step_ops_stream_us"][
            "value"] > 0


class _NameKeyed:
    """A TimerManager as the program had it before its span recorder."""

    def start(self, name, category="Other"):
        pass

    def stop(self, name):
        pass


class _NoCounters:
    """A span recorder that lost ``counters``."""

    @classmethod
    def instance(cls):
        return cls()

    def spans(self):
        return []


def _load(name):
    from benchmark import tracing
    return tracing.load_reader(name)


@pytest.mark.parametrize("manager, raises", [(_NameKeyed, False),
                                             (_NoCounters, True)])
def test_readers_blank_before_the_recorder_and_fail_when_it_breaks(
        manager, raises, monkeypatch):
    """A program without the span recorder gives no reading; one whose
    recorder lacks what the readers read fails them."""
    import types
    from benchmark import tracing
    monkeypatch.setitem(sys.modules, "mops_tpu_torch",
                        types.ModuleType("mops_tpu_torch"))
    monkeypatch.setitem(sys.modules, "mops_tpu_torch.utils.timer",
                        types.SimpleNamespace(TimerManager=manager))
    ctx = tracing.Context([], [], [tracing.Request(0, "streamline", 0, 1,
                                                   steps=3)], {}, {})
    for name in sorted(PROGRAM):
        read = _load(name)
        if raises:
            with pytest.raises(RuntimeError):
                read(ctx)
        else:
            assert read(ctx) is None, name


def test_readers_fail_on_a_profiled_request_without_their_span(
        tmp_path, monkeypatch):
    """After a traced run the readers find their spans; with a span
    renamed in the program, the reader of that span raises."""
    from mops_tpu_torch.utils.timer import TimerManager
    res = bench_support.run_cpu("ec60-streamline-day", tmp_path, trace=True)
    assert "cellsearch_ms" in res["metrics"]
    mgr = TimerManager.instance()
    for s in mgr.spans():
        if s.name == "cellsearch.query":
            monkeypatch.setattr(s, "name", "cellsearch.lookup")
    from benchmark import tracing
    ctx = tracing.Context([], [], [tracing.Request(0, "streamline", 0, 1,
                                                   steps=3)], {}, {})
    with pytest.raises(RuntimeError, match="cellsearch.query"):
        _load("cellsearch_ms")(ctx)
    assert _load("step_host_us")(ctx) > 0
