"""The port's MOPS_* API, MOPSApp and pymops task classes against
``mops_tpu.api`` and ``mops_tpu.pymops`` on the CPU at fp64, on the same
synthetic mesh, fields, seeds and settings.

Tolerances: trajectory points 1e-6 m and velocities 1e-10 m/s
(tests/test_torch_advect.py's), pathline attributes 1e-8; images NaN masks
equal and values within 1e-9 of the image's largest magnitude.  Without a
card every entry point raises unless it is given the CPU.
"""

import os
import string

import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu import api as japi
from mops_tpu import pymops as jpymops
from mops_tpu_torch import api as papi
from mops_tpu_torch import pymops as ppymops
from mops_tpu_torch.from_jax import mesh_from_jax

torch.set_num_threads(1)


def _raw2(raw_fields):
    return {k: np.asarray(v) * (1.1 if k.startswith("velocity") else 1.0)
            for k, v in raw_fields.items()}


@pytest.fixture(scope="module")
def apps(mesh, raw_fields):
    """(JAX app, port app on the CPU), each Ready with solutions 1 and 2."""
    raw1 = {k: np.asarray(v) for k, v in raw_fields.items()}
    ref = japi.MOPSApp()
    ref.init("cpu", precision="fp64")
    port = papi.MOPSApp()
    port.init("cpu", precision="fp64")
    for a, m in ((ref, mesh), (port, mesh_from_jax(mesh))):
        a.begin()
        a.add_grid(m)
        a.add_solution(1, dict(raw1), timestamp="t1", timestep=0)
        a.add_solution(2, _raw2(raw_fields), timestamp="t2", timestep=1)
        a.end()
    return ref, port


def _assert_lines_close(port, ref, attrs=False):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.line_id == b.line_id and a.duration == b.duration
        assert a.depth == b.depth
        for f, tol in (("points", 1e-6), ("last_point", 1e-6),
                       ("velocity", 1e-10), ("temperature", 1e-10),
                       ("salinity", 1e-10)):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0,
                                       atol=tol, err_msg=f)
        if attrs:
            np.testing.assert_allclose(a.attrs, b.attrs, rtol=0, atol=1e-8)


def _assert_image_close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    scale = np.nanmax(np.abs(ref)) if np.isfinite(ref).any() else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * scale)


def test_state_machine_guards(mesh, raw_fields):
    a = papi.MOPSApp()
    a.init("cpu")
    with pytest.raises(RuntimeError):
        a.end()                      # End outside Configuring
    with pytest.raises(RuntimeError):
        a.run_streamline(mtt.TrajectorySettings(), np.zeros((1, 3)))
    a.begin()
    with pytest.raises(RuntimeError):
        a.end()                      # no grid/solution yet
    with pytest.raises(RuntimeError):
        a.add_solution(1, dict(raw_fields))     # grid before solutions
    a.add_grid(mesh_from_jax(mesh))
    a.add_solution(1, {k: np.asarray(v) for k, v in raw_fields.items()})
    a.add_solution(1, {})            # already present: skipped
    a.end()
    with pytest.raises(KeyError):
        a.active_attribute(1, 7)
    a.active_attribute(1)
    with pytest.raises(RuntimeError):
        a.run_pathline(mtt.TrajectorySettings(), np.zeros((1, 3)))
    with pytest.raises(ValueError):
        papi.MOPSApp().init("cpu", precision="fp16")


def test_solution_id_matches_jax():
    rng = np.random.default_rng(1)
    alphabet = list(string.printable) + ["é", "日", "🌊"]
    for i in range(300):
        stamp = "".join(rng.choice(alphabet, size=rng.integers(0, 24)))
        step = int(rng.integers(-5, 10 ** 6))
        assert papi.solution_id(stamp, step) == japi.solution_id(stamp, step)
    assert papi.solution_id("x", 0) == japi.solution_id("x", 0)


def _seeds(app, **kw):
    return app.generate_sample_points(mtt.SamplingSettings(
        sample_range=(5, 5), lat_range=(-30, 30), lon_range=(-60, 60),
        depth=100.0, **kw))


@pytest.mark.parametrize("method", ["RK4", "EULER"])
def test_streamline_matches_jax(apps, method):
    ref, port = apps
    seeds = _seeds(port)
    np.testing.assert_array_equal(seeds, ref.generate_sample_points(
        mt.SamplingSettings(sample_range=(5, 5), lat_range=(-30, 30),
                            lon_range=(-60, 60), depth=100.0)))
    kw = dict(delta_t=600, simulation_duration=600 * 20, record_t=1200,
              depth=100.0)
    ref.active_attribute(1)
    port.active_attribute(1)
    want = ref.run_streamline(mt.TrajectorySettings(
        method=getattr(mt.CalcMethod, method), fail_mode=mt.FailMode.ZERO,
        **kw), seeds.copy())
    got = port.run_streamline(mtt.TrajectorySettings(
        method=getattr(mtt.CalcMethod, method), fail_mode=mtt.FailMode.ZERO,
        **kw), seeds.copy())
    _assert_lines_close(got, want)
    assert np.isfinite([l.last_point for l in got]).all()


def test_pathline_matches_jax_and_advances_seeds(apps):
    ref, port = apps
    seeds = _seeds(port)
    ref_seeds, port_seeds = seeds.copy(), seeds.copy()
    kw = dict(delta_t=600, simulation_duration=600 * 12, record_t=1200,
              particle_depths=np.linspace(10.0, 800.0, len(seeds)))
    ref.active_attribute(1, 2)
    port.active_attribute(1, 2)
    want = ref.run_pathline(mt.TrajectorySettings(
        fail_mode=mt.FailMode.ZERO, **kw), ref_seeds)
    got = port.run_pathline(mtt.TrajectorySettings(
        fail_mode=mtt.FailMode.ZERO, **kw), port_seeds)
    _assert_lines_close(got, want, attrs=True)
    assert (np.linalg.norm(port_seeds - seeds, axis=1) > 0).any()
    for i, line in enumerate(got):
        np.testing.assert_array_equal(port_seeds[i], line.last_point)


def test_cell_center_and_gaussian_seeding_match_jax(apps, mesh):
    ref, port = apps
    np.testing.assert_array_equal(
        port.generate_sample_points(mtt.SamplingSettings(at_cell_center=True)),
        ref.generate_sample_points(mt.SamplingSettings(at_cell_center=True)))
    cfg = dict(lat_range=(-30, 60), lon_range=(-120, 0))
    got = mtt.seeding.generate_gaussian_points(
        mtt.SamplingSettings(**cfg), 200, 25.0, -90.0, 20.0, seed=7)
    want = mt.seeding.generate_gaussian_points(
        mt.SamplingSettings(**cfg), 200, 25.0, -90.0, 20.0, seed=7)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-8)


@pytest.mark.parametrize("kind", ["depth", "layer", "regrid"])
def test_remap_through_api_matches_jax(apps, kind, tmp_path, monkeypatch):
    ref, port = apps
    ref.active_attribute(1)
    port.active_attribute(1)
    monkeypatch.chdir(tmp_path)
    if kind == "regrid":
        kw = dict(image_width=48, image_height=16, fixed_latitude=20.0)
        want = [ref.run_regrid(mt.VisualizationSettings(**kw))]
        got = [port.run_regrid(mtt.VisualizationSettings(**kw))]
    else:
        kw = dict(image_width=64, image_height=32, fixed_depth=100.0,
                  fixed_layer=2, time_step=3)
        vt = "FIXED_LAYER" if kind == "layer" else "FIXED_DEPTH"
        save = "PNG" if kind == "layer" else "VTI"
        want = ref.run_remapping(mt.VisualizationSettings(
            visualize_type=getattr(mt.VisualizeType, vt),
            save_type=getattr(mt.SaveType, save), **kw))
        os.rename(tmp_path / ("remap_t3.vti" if save == "VTI"
                              else "remap_t3_speed.png"), tmp_path / "ref")
        got = port.run_remapping(mtt.VisualizationSettings(
            visualize_type=getattr(mtt.VisualizeType, vt),
            save_type=getattr(mtt.SaveType, save), **kw))
        if save == "VTI":
            assert (tmp_path / "remap_t3.vti").read_bytes() \
                == (tmp_path / "ref").read_bytes()
        else:
            assert (tmp_path / "remap_t3_speed.png").exists()
    assert len(got) == len(want) == (2 if kind == "depth" else 1)
    for g, w in zip(got, want):
        _assert_image_close(g, w)


def test_global_mops_functions_and_timing(mesh, raw_fields):
    mtt.MOPS_Init("cpu", "fp64")
    mtt.MOPS_ResetTiming()
    mtt.MOPS_Begin()
    mtt.MOPS_AddGridMesh(mesh_from_jax(mesh))
    mtt.MOPS_AddAttribute(1, {k: np.asarray(v)
                              for k, v in raw_fields.items()})
    mtt.MOPS_End()
    mtt.MOPS_ActiveAttribute(1)
    assert mtt.MOPS_GetFieldSnapshots() is papi.app.field
    imgs = mtt.MOPS_RunRemapping(mtt.VisualizationSettings(
        image_width=32, image_height=16))
    assert imgs[0].shape == (16, 32, 3)
    assert mtt.MOPS_RunReGrid(mtt.VisualizationSettings(
        image_width=32, image_height=6, fixed_latitude=10.0)).shape == (6, 32, 3)
    seeds = mtt.MOPS_GenerateSamplePoints(mtt.SamplingSettings(
        sample_range=(3, 3), lat_range=(-20, 20), lon_range=(-20, 20)))
    lines = mtt.MOPS_RunStreamLine(mtt.TrajectorySettings(
        delta_t=600, simulation_duration=3600, record_t=1200), seeds)
    assert len(lines) == len(seeds)
    assert mtt.MOPS_GetCategoryTime("GPUKernel") > 0
    assert mtt.MOPS_GetTotalTime() >= mtt.MOPS_GetCategoryTime("GPUKernel")
    mtt.MOPS_PrintTimingSummary()
    mtt.MOPS_PrintTimingDetailed()


def test_more_than_one_device_raises(monkeypatch):
    """More devices than the machine's cards raises with the count; it
    never runs on fewer devices or falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 devices asked for.* 1 CUDA"):
        papi.MOPSApp().init("cuda", devices=2)
    with pytest.raises(RuntimeError, match="4 devices asked for"):
        mtt.MOPS_Init("cuda", devices=4)


@pytest.mark.parametrize("entry", ["MOPS_Init", "Field", "pymops", "cli"])
def test_entry_points_raise_without_a_card(entry, mesh, sol, tmp_path):
    """The card is the default; without one every entry point raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        if entry == "MOPS_Init":
            mtt.MOPS_Init()
        elif entry == "Field":
            from mops_tpu_torch.from_jax import solution_from_jax
            mtt.Field(mesh_from_jax(mesh), solution_from_jax(sol))
        elif entry == "pymops":
            ppymops.MOPSRemapping(synthetic_cells=100,
                                  output_dir=str(tmp_path))
        else:
            from mops_tpu_torch import cli
            cli.main(["--synthetic", "100", "--out", str(tmp_path)])


TASK_KW = dict(synthetic_cells=400, synthetic_layers=5)


@pytest.mark.parametrize("task", ["remap", "regrid", "streamline",
                                  "pathline"])
def test_pymops_tasks_match_jax(task, tmp_path):
    if task == "remap":
        kw = dict(width=60, height=30, fixed_depth=50.0)
        ref = jpymops.MOPSRemapping(output_dir=str(tmp_path / "j"),
                                    **TASK_KW, **kw)
        port = ppymops.MOPSRemapping(output_dir=str(tmp_path / "p"),
                                     device="cpu", **TASK_KW, **kw)
        for g, w in zip(port.run(), ref.run()):
            _assert_image_close(g, w)
        assert all(os.path.exists(p) for p in port.save())
        assert os.path.exists(port.plot())
    elif task == "regrid":
        kw = dict(width=60, fixed_latitude=30.0)
        ref = jpymops.MOPSReGrid(output_dir=str(tmp_path / "j"),
                                 **TASK_KW, **kw)
        port = ppymops.MOPSReGrid(output_dir=str(tmp_path / "p"),
                                  device="cpu", **TASK_KW, **kw)
        got = port.run()
        assert got.shape == (5, 60, 3)
        _assert_image_close(got, ref.run())
        assert all(os.path.exists(p) for p in port.save())
    elif task == "streamline":
        kw = dict(grid=(4, 4), duration=3600 * 3, delta_t=600, record_t=1200)
        ref = jpymops.MOPSStreamline(output_dir=str(tmp_path / "j"),
                                     **TASK_KW, **kw)
        port = ppymops.MOPSStreamline(output_dir=str(tmp_path / "p"),
                                      device="cpu", **TASK_KW, **kw)
        got = port.run()
        assert len(got) == 9          # (4-1) x (4-1) reference seeding quirk
        _assert_lines_close(got, ref.run())
        assert all(os.path.exists(p) for p in port.save())
        assert os.path.exists(port.plot())
    else:
        kw = dict(timesteps=(0, 1, 2), grid=(3, 3),
                  duration_per_pair=3600 * 2, delta_t=600, record_t=1200)
        ref = jpymops.MOPSPathline(output_dir=str(tmp_path / "j"),
                                   **TASK_KW, **kw)
        port = ppymops.MOPSPathline(output_dir=str(tmp_path / "p"),
                                    device="cpu", **TASK_KW, **kw)
        got = port.run()
        assert got[0].points.shape[0] == 1 + 2 * 6   # 2 pairs x 6 records
        _assert_lines_close(got, ref.run())
        assert all(os.path.exists(p) for p in port.save())
