"""The benchmark's fp64 deployments (configuration ec30to60-L60-fp64, cell
ec60f64-pathline-month; configuration agent-ec30to60-L60-fp64, cell
agent-streamline-5d) on the CPU: each cell cut to a size the CPU runs in
seconds (benchmark/tests/bench_support.shrink) and sent through the
harness's set-up and the MOPS_* API at fp64 agrees with the benchmark's
float64 reference (benchmark/reference.py) within the cell's limits; the
same inputs at fp32 fail at least one of them.  The limits file parses
and each limit lies between the readings it was set from.
agent-streamline-5d's mix is the agent's default streamline job."""

import inspect
import json
from pathlib import Path

import pytest
import torch

from benchmark import check, harness, traffic
from benchmark.tests import bench_support

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["ec60f64-pathline-month", "agent-streamline-5d"]
REQUESTS = 2


def shrink(cell: str, precision: str):
    """The cell's configuration and mix at bench_support's cut size."""
    _, config, mix = harness.cell_of(harness.load_spec(), cell)
    return bench_support.shrink(config, mix, precision)


@pytest.fixture(scope="module")
def mesh_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("meshes")


def numbers(cell: str, precision: str, mesh_cache) -> dict:
    """The check's numbers of REQUESTS requests of the cut cell at
    ``precision`` against the float64 reference."""
    config, mix = shrink(cell, precision)
    run = harness.Run(config, mix, bench_support.SEED, torch.device("cpu"))
    harness.setup(run, mesh_cache, warm=False)
    assert run.app.precision == precision
    for k in range(REQUESTS):
        job = traffic.trajectory_job(mix, run.seed, k)
        out = harness.call(run, k, job=job)
        assert len(out) == job.n
        run.samples.append(harness.sample(run, k, out, job))
    mesh, snaps = harness.reference_tables(run)
    return harness.numbers_of(run, harness.reference_answers(run, mesh,
                                                             snaps))


@pytest.mark.parametrize("cell", CELLS)
def test_fp64_agrees_with_the_float64_reference(cell, mesh_cache):
    ok, table = check.judge(numbers(cell, "fp64", mesh_cache),
                            check.load_limits(cell))
    assert ok, table


@pytest.mark.parametrize("cell", CELLS)
def test_fp32_fails_the_fp64_limits(cell, mesh_cache):
    ok, table = check.judge(numbers(cell, "fp32", mesh_cache),
                            check.load_limits(cell))
    assert not ok, table
    assert any(row["value"] > row["limit"] for row in table.values())


@pytest.mark.parametrize("cell", CELLS)
def test_limits_lie_between_their_readings(cell):
    spec = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json")
                      .read_text())
    assert spec["cell"] == cell
    limits = spec["limits"]
    _, _, mix = harness.cell_of(harness.load_spec(), cell)
    attrs = {"attr_err_first"} if mix["request"] == "pathline" else set()
    assert set(limits) == {"vel_err_first", "vel_err_p50",
                           "parted_first_pct"} | attrs
    for name, row in limits.items():
        assert float(row["lower"]) < float(row["limit"]) < \
            float(row["upper"]), name
        assert "float32" in row["readings"], name
    assert check.load_limits(cell) == {k: float(v["limit"])
                                       for k, v in limits.items()}


def test_the_configuration_is_ec30to60_L60_at_fp64():
    spec = harness.load_spec()
    _, f64, _ = harness.cell_of(spec, "ec60f64-pathline-month")
    _, f32, _ = harness.cell_of(spec, "ec60-pathline-month")
    assert f64["precision"] == "fp64" and f32["precision"] == "fp32"
    differ = {"name", "source", "deployment", "precision", "precision_note"}
    assert {k: v for k, v in f64.items() if k not in differ} == \
        {k: v for k, v in f32.items() if k not in differ}
    cells = {w["name"]: w for w in spec["workloads"]}
    assert [cells[c]["config"] for c in CELLS] == \
        ["ec30to60-L60-fp64", "agent-ec30to60-L60-fp64"]
    assert all(cells[c]["chips"] == 1 for c in CELLS)
    # the agent's deployment runs the same mesh at the same precision
    _, agent, _ = harness.cell_of(spec, "agent-streamline-5d")
    run = ("n_cells", "n_vert_levels", "precision", "mesh", "reduced")
    assert {k: agent[k] for k in run} == {k: f64[k] for k in run}


def test_the_agent_cell_is_the_agents_default_streamline_job():
    """agent-streamline-5d's mix is DEFAULT_STREAMLINE_CONFIG after unit
    conversion: grid, box, depth, step, duration, records and method as
    the config gives them, fail mode and direction as its rendered job
    sets them; the configuration's job states the same defaults; both
    samplers give the grid's 56 seeds, every lane is checked, and the
    configuration's precision is MOPSApp.init's default."""
    import mops_tpu_torch as mtt
    from mops_tpu_torch import api
    from mops_tpu_torch.agent import task_templates
    agent = task_templates.DEFAULT_STREAMLINE_CONFIG
    cell, config, mix = harness.cell_of(harness.load_spec(),
                                        "agent-streamline-5d")
    assert (cell["config"], cell["chips"]) == ("agent-ec30to60-L60-fp64", 1)
    stated = config["job"]
    assert {k: stated[k] for k in stated
            if k not in ("fail_mode", "direction")} == \
        {k: agent[k] for k in stated if k in agent}
    assert (stated["fail_mode"], stated["direction"]) == \
        (mix["trajectory"]["fail_mode"], mix["trajectory"]["direction"])
    assert mix["request"] == "streamline" and len(mix["snapshots"]) == 1
    seeds, traj = mix["seeds"], mix["trajectory"]
    assert seeds["sample_range"] == agent["grid"]
    assert seeds["lat_range"] == agent["lat_range"]
    assert seeds["lon_range"] == agent["lon_range"]
    assert seeds["depth_range"] == [agent["fixed_depth"]] * 2
    assert traj["delta_t"] == agent["delta_minutes"] * 60
    assert traj["duration"] == agent["duration_days"] * mtt.ONE_DAY
    assert traj["record_t"] == agent["record_every_minutes"] * 60
    assert traj["method"] == agent["method"]
    job = task_templates.render_job("streamline", agent)
    assert "fail_mode=mtt.FailMode.ZERO" in job
    assert traj["fail_mode"] == mtt.FailMode.ZERO.value
    assert "direction=" not in job
    assert traj["direction"] == "forward" and \
        mtt.TrajectorySettings().direction == mtt.CalcDirection.FORWARD
    assert "app.init(CONFIG[\"device\"])" in job
    assert traffic.n_steps(traj) == 7200
    lat, lon, _ = traffic.grid_axes(seeds)
    assert len(lat) * len(lon) == 56
    assert traffic.trajectory_job(mix, bench_support.SEED, 0).n == 56
    sampled = mtt.seeding.generate_sample_points(mtt.SamplingSettings(
        sample_range=tuple(agent["grid"]), lat_range=tuple(agent["lat_range"]),
        lon_range=tuple(agent["lon_range"]), depth=agent["fixed_depth"]))
    assert len(sampled) == 56
    assert mix["check"]["lanes_per_request"] == 56
    default = inspect.signature(api.MOPSApp.init).parameters["precision"]
    assert default.default == config["precision"] == "fp64"
