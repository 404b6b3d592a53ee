"""The benchmark's fp64 deployment (configuration ec30to60-L60-fp64, cell
ec60f64-pathline-month) on the CPU: the cell cut to a size the CPU runs in
seconds (benchmark/tests/bench_support.shrink) and sent through the
harness's set-up and the MOPS_* API at fp64 agrees with the benchmark's
float64 reference (benchmark/reference.py) within the cell's limits; the
same inputs at fp32 fail at least one of them.  The limits file parses
and each limit lies between the readings it was set from."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import check, harness, traffic
from benchmark.tests import bench_support

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["ec60f64-pathline-month"]
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
    assert set(limits) == {"vel_err_first", "attr_err_first", "vel_err_p50",
                           "parted_first_pct"}
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
    assert {cells[c]["config"] for c in CELLS} == {"ec30to60-L60-fp64"}
    assert all(cells[c]["chips"] == 1 for c in CELLS)
