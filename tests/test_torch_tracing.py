"""utils.timer, the port's span recorder, on the CPU: nesting, threads, the
ring bound, leaf-only category totals, the profiler's clock, detail on and
off, the counters, and the spans the API, the step loop, remap and set-up
record.  Imports no jax."""

import contextlib
import importlib
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mops_tpu_torch as mtt
from mops_tpu_torch import advect
from mops_tpu_torch import api as papi
from mops_tpu_torch import native
from mops_tpu_torch.kernels import stage_kernel as sk

# the module (mops_tpu_torch.utils.timer names the function ``timer``)
tm = importlib.import_module("mops_tpu_torch.utils.timer")

SETUP = {"mesh.from_raw", "solution.preprocess", "cellsearch.build"}


@pytest.fixture
def mgr():
    m = tm.TimerManager.instance()
    m.reset()
    return m


@pytest.fixture(scope="module")
def case():
    mesh = mtt.synth.build_voronoi_mesh(500, n_layers=6)
    # vertical flow fast enough that the window of 4 layers misses
    raw = mtt.synth.solid_body_fields(mesh, n_layers=6, w_scale=0.1)
    seeds = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=(9, 9), lat_range=(-60, 60), lon_range=(-170, 170)))
    cfg = mtt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 12, record_t=1200,
        particle_depths=np.linspace(10.0, 3900.0, len(seeds)).astype(
            np.float32))
    return mesh, raw, seeds, cfg


@pytest.fixture(scope="module")
def app(case):
    mesh, raw, _, _ = case
    a = papi.MOPSApp()
    a.init("cpu", "fp64")
    a.begin()
    a.add_grid(mesh)
    a.add_solution(1, raw)
    a.end()
    return a


def _window_on(monkeypatch):
    """The window path for use_window=None, as on the card (W = 4 at L6)."""
    resolve = advect.resolve_window
    monkeypatch.setattr(advect, "WINDOW_LAYERS", 4)
    monkeypatch.setattr(
        advect, "resolve_window", lambda use_kernel, use_window, *a:
        resolve(use_kernel, True if use_window is None else use_window, *a))


def _of(spans, request, name=None):
    return [s for s in spans if s.request == request
            and (name is None or s.name == name)]


def _request_id(spans, name):
    return [s for s in spans if s.name == name][-1].request


def test_nesting_parent_and_request_ids(mgr):
    with mgr.request("api.test"):
        with mgr.span("outer", "CPUCompute"):
            with mgr.span("inner"):
                pass
        with mgr.span("second", "Other"):
            pass
    with mgr.span("alone", "Other"):
        pass
    by = {s.name: s for s in mgr.spans()}
    assert [s.name for s in mgr.spans()] == ["inner", "outer", "second",
                                             "api.test", "alone"]
    assert by["inner"].parent == by["outer"].id
    assert by["outer"].parent == by["second"].parent == by["api.test"].id
    assert by["api.test"].parent is None and by["alone"].parent is None
    rid = by["api.test"].request
    assert rid is not None and by["alone"].request is None
    assert all(by[n].request == rid for n in ("inner", "outer", "second"))
    for s in by.values():
        assert s.end_ns >= s.start_ns and s.host_ns == s.end_ns - s.start_ns
        assert s.device_ms is None and s.ms == s.host_ms
    assert by["outer"].start_ns <= by["inner"].start_ns \
        <= by["inner"].end_ns <= by["outer"].end_ns


def test_two_threads_same_name_regions(mgr):
    """Same-name regions open at once in two threads nest on each thread's
    own stack and each gets its own request."""
    barrier = threading.Barrier(2)

    def work():
        with mgr.request("api.thread"):
            with mgr.span("region", "CPUCompute"):
                barrier.wait()
                with mgr.span("region", "Other"):
                    barrier.wait()
                    time.sleep(0.01)
    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = mgr.spans()
    tops = [s for s in spans if s.name == "api.thread"]
    assert len(tops) == 2 and tops[0].request != tops[1].request
    by_id = {s.id: s for s in spans}
    for top in tops:
        mine = _of(spans, top.request, "region")
        assert len(mine) == 2
        outer = [s for s in mine if s.category == "CPUCompute"][0]
        inner = [s for s in mine if s.category == "Other"][0]
        assert outer.parent == top.id and inner.parent == outer.id
        assert by_id[inner.parent].request == top.request
        assert inner.host_ns >= 10_000_000 and outer.host_ns >= inner.host_ns


def test_counters_and_totals_lose_nothing_under_threads(mgr):
    """More threads than cores adding counts and spans at a short switch
    interval: no count and no millisecond is lost."""
    import os
    import sys
    n_threads, n = 2 * (os.cpu_count() or 4), 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with mgr.request("api.stress"):
                    mgr.add("stress")
                    t = time.time_ns()
                    mgr.record("leaf", "Other", t, t + 1_000_000)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert mgr.counter("stress") == n_threads * n
    assert mgr.category_time("Other") == pytest.approx(n_threads * n * 1.0)
    counts = mgr.counters()
    assert all(c == {"stress": 1} for c in counts.values())
    mgr.reset_counter("stress")


def test_ring_bound_keeps_the_totals(monkeypatch):
    monkeypatch.setattr(tm, "RING", 8)
    monkeypatch.setattr(tm, "REQUESTS", 4)
    m = tm.TimerManager()
    t = time.time_ns()
    for i in range(20):
        m.record(f"s{i}", "Other", t, t + 1_000_000)
    assert [s.name for s in m.spans()] == [f"s{i}" for i in range(12, 20)]
    assert m.category_time("Other") == pytest.approx(20.0)
    for _ in range(6):
        with m.request("api.r"):
            m.add("c")
    assert len(m.counters()) == 4 and m.counter("c") == 6


def test_leaf_only_category_totals(mgr):
    """A categorized span counts its time less that of the categorized
    spans nested in it; uncategorized spans count nothing."""
    with mgr.request("api.test"):
        with mgr.span("outer", "Preprocessing") as outer:
            t = time.time_ns()
            mgr.record("inner", "CPUCompute", t, t + 5_000_000)
            with mgr.span("group"):
                mgr.record("deep", "IO_Read", t, t + 2_000_000)
            time.sleep(0.01)
    assert mgr.category_time("CPUCompute") == pytest.approx(5.0)
    assert mgr.category_time("IO_Read") == pytest.approx(2.0)
    assert mgr.category_time("Preprocessing") == pytest.approx(
        outer.host_ms - 7.0)
    assert mgr.total_time() == pytest.approx(outer.host_ms)
    assert mgr.summary() == {"CPUCompute": pytest.approx(5.0),
                             "IO_Read": pytest.approx(2.0),
                             "Preprocessing": pytest.approx(
                                 outer.host_ms - 7.0)}


def test_spans_share_the_profilers_clock(mgr):
    """Under a CPU torch.profiler, a span around a torch op contains the
    op's kineto event on one time axis."""
    a = torch.randn(256, 256, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with mgr.request("api.test"):
            assert mgr.detail()
            with mgr.span("matmul", "CPUCompute") as span:
                torch.mm(a, a)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert len(events) == 1
    start = events[0].start_ns()
    end = start + events[0].duration_ns()
    assert span.start_ns <= start <= end <= span.end_ns


def test_api_totals_equal_the_requests_leaf_time(app, case, mgr):
    _, _, seeds, cfg = case
    mtt.MOPS_ResetTiming()
    lines = app.run_streamline(cfg, seeds.copy())
    assert len(lines) == len(seeds)
    spans = mgr.spans()
    rid = _request_id(spans, "api.streamline")
    mine = _of(spans, rid)
    # (the first request also builds the cell search, inside its query)
    assert {s.name for s in mine} - {"cellsearch.build"} == {
        "api.streamline", "cellsearch.query", "advect.prepare",
        "advect.loop", "advect.wait", "advect.readback",
        "trajectory.finalize"}
    leaf = sum(s.leaf_ms() for s in mine if s.category is not None)
    total = mtt.MOPS_GetTotalTime()
    assert total == pytest.approx(leaf, rel=0.01)
    top = _of(spans, rid, "api.streamline")[0]
    assert 0 < total <= top.host_ms
    fin = _of(spans, rid, "trajectory.finalize")[0]
    # the read-back is the finalized blocks', inside finalize
    assert _of(spans, rid, "advect.readback")[0].parent == fin.id
    assert all(s.parent == top.id for s in mine
               if s is not top and s.name not in ("cellsearch.build",
                                                  "advect.readback"))


def test_categories_hold_finalize_loop_and_readback(app, case, mgr):
    """GPUKernel is the step loop (its stream time; the host's on the
    CPU), CPUCompute the cell search and finalize less the read-back
    nested in it, MemoryCopy the read-back."""
    _, _, seeds, cfg = case
    app.run_streamline(cfg, seeds.copy())
    spans = mgr.spans()
    rid = _request_id(spans, "api.streamline")
    one = {s.name: s for s in _of(spans, rid)}
    assert mgr.category_time("GPUKernel") == pytest.approx(
        one["advect.loop"].ms)
    assert mgr.category_time("CPUCompute") == pytest.approx(
        one["trajectory.finalize"].leaf_ms()
        + one["cellsearch.query"].leaf_ms())
    assert mgr.category_time("MemoryCopy") == pytest.approx(
        one["advect.readback"].host_ms)
    assert one["trajectory.finalize"].host_ms > 0


def test_detail_off_without_a_profiler(app, case, mgr, monkeypatch):
    _window_on(monkeypatch)
    _, _, seeds, cfg = case
    app.run_streamline(cfg, seeds.copy())
    spans = mgr.spans()
    rid = _request_id(spans, "api.streamline")
    assert not any(s.detail for s in _of(spans, rid))
    assert not any(s.name in advect.PHASES for s in spans)
    assert mgr.counters()[rid] == {"advect.graph_steps": 0}


def test_detail_on_under_a_profiler(app, case, mgr, monkeypatch):
    """Under a profiler each phase is a span under advect.loop, and the
    request counts its steps and window misses."""
    _window_on(monkeypatch)
    _, _, seeds, cfg = case
    with profile(activities=[ProfilerActivity.CPU]):
        app.run_streamline(cfg, seeds.copy())
    spans = mgr.spans()
    rid = _request_id(spans, "api.streamline")
    mine = _of(spans, rid)
    assert all(s.detail for s in mine)
    loop = [s for s in mine if s.name == "advect.loop"][0]
    phases = [s for s in mine if s.name in advect.PHASES]
    assert [s.name for s in phases] == list(advect.PHASES)
    assert all(s.parent == loop.id and s.category is None for s in phases)
    assert sum(s.host_ns for s in phases) <= loop.host_ns
    counts = mgr.counters()[rid]
    assert counts["advect.steps"] == cfg.n_steps
    assert counts["advect.window_misses"] >= \
        counts["advect.window_clamp_misses"] >= 0


def test_cut_lines_counts_the_lines_with_a_non_finite_point(mgr):
    """With detail on, finalize counts the lines its NaN cut engaged on;
    with detail off it counts nothing."""
    rng = np.random.default_rng(3)
    seeds = rng.normal(size=(10, 3))
    pts = torch.from_numpy(rng.normal(size=(10, 4, 3)).astype(np.float32))
    vels = torch.zeros_like(pts)
    pts[1, 0, 0] = float("nan")
    pts[4, 2, 1] = float("inf")
    pts[4, 3, 1] = float("nan")
    seeds[7, 2] = np.nan
    cfg = mtt.TrajectorySettings(delta_t=60, record_t=60,
                                 simulation_duration=240)
    with profile(activities=[ProfilerActivity.CPU]):
        with mgr.request("api.test"):
            mtt.finalize_trajectories(seeds, pts, vels, cfg)
    with mgr.request("api.test"):
        mtt.finalize_trajectories(seeds, pts, vels, cfg)
    on, off = [s.request for s in mgr.spans() if s.name == "api.test"]
    counts = mgr.counters()
    assert counts[on] == {"trajectory.cut_lines": 3}
    assert counts[off] == {}


def _two_snapshot_app(case):
    """A CPU app with the case's field as snapshots 1 and 2."""
    mesh, raw, _, _ = case
    a = papi.MOPSApp()
    a.init("cpu", "fp64")
    a.begin()
    a.add_grid(mesh)
    a.add_solution(1, raw)
    a.add_solution(2, raw)
    a.end()
    return a


def _prepare_as_for_a_card(monkeypatch):
    """A CPU app prepares its requests' host blocks on its worker thread
    as it does for records on a card."""
    real = papi.MOPSApp._host_blocks
    monkeypatch.setattr(
        papi.MOPSApp, "_host_blocks",
        lambda self, device, *a: real(self, torch.device("cuda"), *a))


READBACK = ("trajectory.readback_blocks", "trajectory.readback_ready")


def test_readback_counters_count_every_prepared_request(case, mgr,
                                                        monkeypatch):
    """A request whose host blocks were prepared counts its read-back
    blocks and the ready ones, untraced and traced: two a streamline,
    four a pathline, all ready; each waits for them once, inside
    finalize."""
    _prepare_as_for_a_card(monkeypatch)
    _, _, seeds, cfg = case
    a = _two_snapshot_app(case)
    for pathline in (False, True):
        a.active_attribute(*((1, 2) if pathline else (1,)))
        run = a.run_pathline if pathline else a.run_streamline
        run(cfg, seeds.copy())
        with profile(activities=[ProfilerActivity.CPU]):
            run(cfg, seeds.copy())
        name = "api.pathline" if pathline else "api.streamline"
        spans = mgr.spans()
        counts = mgr.counters()
        n = 4 if pathline else 2
        for rid in [s.request for s in spans if s.name == name][-2:]:
            assert {k: counts[rid][k] for k in READBACK} == dict.fromkeys(
                READBACK, n)
            fin, = _of(spans, rid, "trajectory.finalize")
            wait, = _of(spans, rid, "trajectory.prefault_wait")
            assert (wait.parent, wait.category) == (fin.id, "Other")
    assert a._worker is not None


def test_cpu_requests_prepare_nothing(case, mgr):
    """Through the API on the CPU nothing is read back: no worker, no
    prefault wait, no block counted ready."""
    _, _, seeds, cfg = case
    a = _two_snapshot_app(case)
    for pathline in (False, True):
        a.active_attribute(*((1, 2) if pathline else (1,)))
        (a.run_pathline if pathline else a.run_streamline)(cfg, seeds.copy())
        rid = _request_id(mgr.spans(), "api.pathline" if pathline
                          else "api.streamline")
        assert mgr.counters()[rid].get("trajectory.readback_ready", 0) == 0
        assert not _of(mgr.spans(), rid, "trajectory.prefault_wait")
    assert a._worker is None


def test_prefault_wait_keeps_the_totals_and_the_categories(case, mgr,
                                                           monkeypatch):
    """With its host blocks prepared, a request's category totals still
    equal its leaf time: Other holds advect.wait and
    trajectory.prefault_wait, MemoryCopy the read-back, CPUCompute the cell
    search and finalize less both spans nested in it."""
    _prepare_as_for_a_card(monkeypatch)
    _, _, seeds, cfg = case
    a = _two_snapshot_app(case)
    a.run_streamline(cfg, seeds.copy())
    mtt.MOPS_ResetTiming()
    a.run_streamline(cfg, seeds.copy())
    spans = mgr.spans()
    rid = _request_id(spans, "api.streamline")
    mine = _of(spans, rid)
    one = {s.name: s for s in mine}
    assert set(one) == {
        "api.streamline", "cellsearch.query", "advect.prepare",
        "advect.loop", "advect.wait", "trajectory.prefault_wait",
        "advect.readback", "trajectory.finalize"}
    fin = one["trajectory.finalize"]
    assert one["trajectory.prefault_wait"].parent == fin.id
    assert one["advect.readback"].parent == fin.id
    assert mtt.MOPS_GetTotalTime() == pytest.approx(
        sum(s.leaf_ms() for s in mine if s.category is not None), rel=0.01)
    assert mgr.category_time("Other") == pytest.approx(
        one["advect.wait"].host_ms + one["trajectory.prefault_wait"].host_ms)
    assert mgr.category_time("MemoryCopy") == pytest.approx(
        one["advect.readback"].host_ms)
    assert mgr.category_time("CPUCompute") == pytest.approx(
        fin.leaf_ms() + one["cellsearch.query"].leaf_ms())
    assert fin.leaf_ms() == pytest.approx(
        fin.host_ms - one["advect.readback"].host_ms
        - one["trajectory.prefault_wait"].host_ms)


def test_window_miss_counter_equals_the_runs_misses(case, mgr, monkeypatch):
    mesh, raw, seeds, cfg = case
    sol = mtt.preprocess(mesh, raw, device="cpu")
    cells = mtt.CellSearch(mesh).query(seeds)
    monkeypatch.setattr(advect, "WINDOW_LAYERS", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        with mgr.request("api.test"):
            got = advect.run_advection(mesh, sol, seeds, cells, cfg,
                                       device="cpu", use_window=True)
    rid = _request_id(mgr.spans(), "api.test")
    counts = mgr.counters()[rid]
    misses = int(got.window_misses.sum())
    assert misses > 0
    assert counts["advect.window_misses"] == misses
    assert counts["advect.window_clamp_misses"] == \
        int(got.window_clamp_misses.sum())


def test_launch_counts_read_the_recorder(mgr):
    sk.reset_counts()
    assert sk.launch_counts() == dict.fromkeys(sk.COUNT_KEYS, 0)
    for key, n in (("k1", 2), ("k3", 3), ("k3 repair", 3), ("k4 repair", 1)):
        mgr.add(sk.LAUNCHES + key, n)
    counts = sk.launch_counts()
    assert counts == {"k1": 2, "k2": 0, "k3": 3, "k3 repair": 3, "k4": 0,
                      "k4 repair": 1}
    sk.reset_counts()
    assert sk.launch_counts() == dict.fromkeys(sk.COUNT_KEYS, 0)
    assert mgr.counter(sk.LAUNCHES + "k3") == 0


def test_native_build_is_counted(mgr):
    before = mgr.counter("kernels.compiled") + mgr.counter("kernels.cached")
    path = native.build()
    after = mgr.counter("kernels.compiled") + mgr.counter("kernels.cached")
    assert after == before + (path is not None)


def test_remap_spans_and_pixel_cache_counter(app, mgr):
    cfg = mtt.VisualizationSettings(image_width=48, image_height=24,
                                    fixed_depth=15.0)
    rids = []
    for _ in range(2):
        app.run_remapping(cfg)
        rids.append(_request_id(mgr.spans(), "api.remap"))
    spans = mgr.spans()
    for rid in rids:
        names = [s.name for s in _of(spans, rid) if s.name != "mesh.to"]
        assert names == ["remap.pixels", "remap.launch", "remap.wait",
                         "remap.readback", "api.remap"]
    counts = mgr.counters()
    assert counts[rids[0]].get("remap.pixel_cache_miss") == 1
    assert "remap.pixel_cache_miss" not in counts[rids[1]]
    one = {s.name: s for s in _of(spans, rids[1])}
    assert one["remap.launch"].category == "GPUKernel"
    assert one["remap.readback"].category == "MemoryCopy"


def test_set_up_spans(case, mgr):
    """Set-up records mesh.from_raw, mesh.to (only when it moves data),
    solution.preprocess and cellsearch.build, outside any request."""
    mesh, raw, _, _ = case
    host = mtt.MPASMesh.from_raw(
        cell_xyz=mesh.cell_xyz.numpy(), vertex_xyz=mesh.vertex_xyz.numpy(),
        edge_xyz=mesh.edge_xyz.numpy(),
        n_edges_on_cell=mesh.n_edges_on_cell.numpy(),
        vertices_on_cell_1based=mesh.vertices_on_cell.numpy() + 1,
        cells_on_cell_1based=mesh.cells_on_cell.numpy() + 1,
        cells_on_vertex_1based=mesh.cells_on_vertex.numpy() + 1,
        edges_on_cell_1based=mesh.edges_on_cell.numpy() + 1,
        cells_on_edge_1based=mesh.cells_on_edge.numpy() + 1,
        vertices_on_edge_1based=mesh.vertices_on_edge.numpy() + 1)
    same = host.to("cpu", torch.float64)
    assert [s.name for s in mgr.spans()] == ["mesh.from_raw"]
    host.to("cpu", torch.float32)
    mtt.preprocess(same, raw, device="cpu")
    mtt.CellSearch(same)
    names = [s.name for s in mgr.spans()]
    assert names == ["mesh.from_raw", "mesh.to", "solution.preprocess",
                     "cellsearch.build"]
    assert SETUP <= set(names)
    assert all(s.request is None and s.category == "Preprocessing"
               for s in mgr.spans())


def test_request_span_keeps_precision_and_path(app, case, mgr, monkeypatch,
                                               capsys):
    """A trajectory request's span keeps the app's precision and the path
    its run resolved (advect.LAST_RESOLVED), and the detailed report
    prints them; an image request keeps the precision alone."""
    _window_on(monkeypatch)
    _, _, seeds, cfg = case
    app.run_streamline(cfg, seeds.copy())
    top = [s for s in mgr.spans() if s.name == "api.streamline"][-1]
    assert top.meta == {"precision": "fp64",
                        "path": dict(advect.LAST_RESOLVED)}
    assert top.meta["path"]["n_window"] == 4
    assert top.meta["path"]["dtype"] == "float64"
    assert all(s.meta is None for s in mgr.spans() if s is not top)
    app.run_remapping(mtt.VisualizationSettings(
        image_width=16, image_height=8, fixed_depth=20.0,
        save_type=mtt.SaveType.NONE))
    image = [s for s in mgr.spans() if s.name == "api.remap"][-1]
    assert image.meta == {"precision": "fp64"}
    mgr.print_detailed()
    out = capsys.readouterr().out
    assert out.count("precision: fp64") == 2
    assert "path: {'kernel': 'k3'" in out


def test_untraced_request_spans_as_they_were(app, case, mgr, monkeypatch):
    """Without a profiler a request records the coarse spans alone, in
    their order, and counts only its replayed steps (none on the CPU)."""
    _window_on(monkeypatch)
    _, _, seeds, cfg = case
    app.run_streamline(cfg, seeds.copy())
    app.run_streamline(cfg, seeds.copy())
    spans = mgr.spans()
    rid = _request_id(spans, "api.streamline")
    assert [s.name for s in _of(spans, rid)] == [
        "cellsearch.query", "advect.prepare", "advect.loop", "advect.wait",
        "advect.readback", "trajectory.finalize", "api.streamline"]
    assert not any(s.detail for s in _of(spans, rid))
    assert mgr.counters()[rid] == {"advect.graph_steps": 0}


def _f64_launch_pct():
    from benchmark import tracing
    return tracing.load_reader("f64_launch_pct")


def _streamline_ctx():
    from benchmark import tracing
    return tracing.Context([], [], [tracing.Request(0, "streamline", 0, 1,
                                                    steps=3)], {}, {})


def test_f64_launch_pct_is_none_on_the_plain_path(app, case, mgr):
    """A profiled request whose steps ran the plain torch versions counts
    no launch, so the share reads nothing."""
    _, _, seeds, cfg = case
    with profile(activities=[ProfilerActivity.CPU]):
        app.run_streamline(cfg, seeds.copy())
    rid = _request_id(mgr.spans(), "api.streamline")
    assert not any(k.startswith(sk.LAUNCHES) for k in mgr.counters()[rid])
    assert _f64_launch_pct()(_streamline_ctx()) is None


def test_f64_launch_pct_reads_the_profiled_requests_counters(mgr):
    """Each launch counts under kernels.launches.<key> and, for the double
    instance, under kernels.f64_launches.<key> too; the share is the
    second over the first, summed over the profiled requests (an
    unprofiled one left out)."""
    def request(dtype, keys, traced=True):
        with contextlib.ExitStack() as stack:
            if traced:
                stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
            with mgr.request("api.streamline"):
                for key in keys:
                    sk.count_launch(key, dtype)
        return _request_id(mgr.spans(), "api.streamline")

    rid = request(torch.float64, ["k3", "k3 repair"] * 5)
    counts = mgr.counters()[rid]
    assert {k: v for k, v in counts.items()
            if k.startswith(sk.F64_LAUNCHES)} == {
        sk.F64_LAUNCHES + "k3": 5, sk.F64_LAUNCHES + "k3 repair": 5}
    assert counts[sk.LAUNCHES + "k3"] == 5
    request(torch.float32, ["k1"] * 7, traced=False)
    assert _f64_launch_pct()(_streamline_ctx()) == 100.0
    request(torch.float32, ["k4", "k4 repair"] * 5)
    assert _f64_launch_pct()(_streamline_ctx()) == 50.0
    mgr.reset()
    request(torch.float32, ["k4", "k4 repair"])
    assert not any(k.startswith(sk.F64_LAUNCHES)
                   for c in mgr.counters().values() for k in c)
    assert _f64_launch_pct()(_streamline_ctx()) is None
    sk.reset_counts()


def _graph_step_pct():
    from benchmark import tracing
    return tracing.load_reader("graph_step_pct")


def test_graph_steps_read_zero_on_the_cpu_and_on_a_pathline(case, mgr):
    """A CPU run and a pathline keep the eager loop: each request counts
    advect.graph_steps 0, traced or not, and graph_step_pct reads 0 over
    the profiled requests that stepped; they capture nothing (no
    advect.capture span, no advect.captures count), so capture_ms reads
    nothing."""
    mesh, raw, seeds, cfg = case
    a = papi.MOPSApp()
    a.init("cpu", "fp64")
    a.begin()
    a.add_grid(mesh)
    a.add_solution(1, raw)
    a.add_solution(2, raw)
    a.end()
    for pathline in (False, True):
        a.active_attribute(*((1, 2) if pathline else (1,)))
        run = a.run_pathline if pathline else a.run_streamline
        run(cfg, seeds.copy())
        with profile(activities=[ProfilerActivity.CPU]):
            run(cfg, seeds.copy())
        name = "api.pathline" if pathline else "api.streamline"
        untraced, traced = [s.request for s in mgr.spans()
                            if s.name == name][-2:]
        counts = mgr.counters()
        assert counts[untraced]["advect.graph_steps"] == 0
        assert counts[traced]["advect.graph_steps"] == 0
        assert counts[traced]["advect.steps"] == cfg.n_steps
        for r in (untraced, traced):
            assert "advect.captures" not in counts[r]
            assert not _of(mgr.spans(), r, "advect.capture")
        from benchmark import tracing
        ctx = tracing.Context([], [], [tracing.Request(
            0, "pathline" if pathline else "streamline", 0, 1,
            steps=cfg.n_steps)], {}, {})
        assert _graph_step_pct()(ctx) == 0.0
        assert _capture_ms()(ctx) is None


def test_graph_step_pct_reads_the_replayed_share(case, mgr):
    """Replayed steps over stepped ones, in %, over the profiled requests:
    a graphed run replays all steps but the warm-up's."""
    mesh, raw, seeds, cfg = case
    sol = mtt.preprocess(mesh, raw, device="cpu")
    cells = mtt.CellSearch(mesh).query(seeds)
    with profile(activities=[ProfilerActivity.CPU]):
        with mgr.request("api.streamline"):
            advect.run_advection(mesh, sol, seeds, cells, cfg, device="cpu",
                                 graph=True)
    rid = _request_id(mgr.spans(), "api.streamline")
    replayed = cfg.n_steps - advect.GRAPH_WARM_STEPS
    assert mgr.counters()[rid]["advect.graph_steps"] == replayed
    assert _graph_step_pct()(_streamline_ctx()) == \
        100.0 * replayed / cfg.n_steps


def test_graph_step_pct_is_none_without_spans_or_its_counter(mgr,
                                                             monkeypatch):
    """None where the program records no spans (a name-keyed recorder) or
    its profiled requests count no replays (a program without the graphed
    loop)."""
    import sys
    import types
    with profile(activities=[ProfilerActivity.CPU]):
        with mgr.request("api.streamline"):
            mgr.add("advect.steps", 3)
    assert _graph_step_pct()(_streamline_ctx()) is None
    old = types.ModuleType("mops_tpu_torch.utils.timer")
    old.TimerManager = type("TimerManager", (), {"start": None,
                                                 "stop": None})
    monkeypatch.setitem(sys.modules, "mops_tpu_torch.utils.timer", old)
    assert _graph_step_pct()(_streamline_ctx()) is None


def _capture_ms():
    from benchmark import tracing
    return tracing.load_reader("capture_ms")


def _graphed_request(case, mgr, traced):
    """One run_advection(graph=True) on the CPU inside a request (under a
    profiler if ``traced``); returns the request id."""
    mesh, raw, seeds, cfg = case
    sol = mtt.preprocess(mesh, raw, device="cpu")
    cells = mtt.CellSearch(mesh).query(seeds)
    with contextlib.ExitStack() as stack:
        if traced:
            stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
        with mgr.request("api.streamline"):
            advect.run_advection(mesh, sol, seeds, cells, cfg, device="cpu",
                                 graph=True)
    return _request_id(mgr.spans(), "api.streamline")


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "detail"])
def test_capture_is_spanned_and_counted_once_a_graphed_call(case, mgr,
                                                            traced):
    """A graphed run_advection keeps one advect.capture span (host time,
    Preprocessing, inside advect.loop) and counts the graphs it captured
    under advect.captures: one, or under detail one a phase (the record
    phase stays eager)."""
    rid = _graphed_request(case, mgr, traced)
    mine = _of(mgr.spans(), rid)
    capture = [s for s in mine if s.name == "advect.capture"]
    loop = [s for s in mine if s.name == "advect.loop"]
    assert len(capture) == 1 and len(loop) == 1
    assert capture[0].parent == loop[0].id
    assert capture[0].category == "Preprocessing"
    assert capture[0].device_ms is None and capture[0].host_ms > 0
    assert capture[0].detail == traced
    graphs = len(advect.PHASES) - 1 if traced else 1
    assert mgr.counters()[rid]["advect.captures"] == graphs


def test_capture_ms_reads_the_profiled_requests_span(case, mgr):
    """capture_ms is the profiled requests' advect.capture host ms over
    their count; an unprofiled graphed request is left out."""
    _graphed_request(case, mgr, traced=False)
    rid = _graphed_request(case, mgr, traced=True)
    span = [s for s in _of(mgr.spans(), rid) if s.name == "advect.capture"]
    assert _capture_ms()(_streamline_ctx()) == span[0].host_ms > 0


def test_capture_ms_is_none_without_spans_or_captures(mgr, monkeypatch):
    """None where the program records no spans (a name-keyed recorder) or
    its profiled requests count no captures (a program without the span);
    a count of captures that no span timed raises."""
    import sys
    import types
    with profile(activities=[ProfilerActivity.CPU]):
        with mgr.request("api.streamline"):
            mgr.add("advect.graph_steps", 3)
    assert _capture_ms()(_streamline_ctx()) is None
    with profile(activities=[ProfilerActivity.CPU]):
        with mgr.request("api.streamline"):
            mgr.add("advect.captures", 1)
    with pytest.raises(RuntimeError, match="advect.capture"):
        _capture_ms()(_streamline_ctx())
    old = types.ModuleType("mops_tpu_torch.utils.timer")
    old.TimerManager = type("TimerManager", (), {"start": None,
                                                 "stop": None})
    monkeypatch.setitem(sys.modules, "mops_tpu_torch.utils.timer", old)
    assert _capture_ms()(_streamline_ctx()) is None
