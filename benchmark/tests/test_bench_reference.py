"""The reference against the port's plain CPU path at a tiny size, on each
cell's traffic: at float64 through the MOPS_* API they agree to rounding;
at float32 the reference and the program's plain path take the same
arithmetic and read the same numbers."""

import numpy as np
import pytest
import torch

import bench_support
from benchmark import check, harness, reference, traffic


def program_and_reference(cell, mesh_cache, precision, ar):
    spec = harness.load_spec()
    _, config, mix = harness.cell_of(spec, cell)
    config, mix = bench_support.shrink(config, mix, precision)
    run = harness.Run(config, mix, bench_support.SEED, torch.device("cpu"))
    harness.setup(run, mesh_cache)
    for k in range(2):
        job = None if run.kind == "remap" \
            else traffic.trajectory_job(mix, run.seed, k)
        run.samples.append(harness.sample(run, k, harness.call(run, k,
                                                               job=job), job))
    mesh, snaps = harness.reference_tables(run, ar)
    return run, harness.reference_answers(run, mesh, snaps, ar)


@pytest.mark.parametrize("cell", bench_support.CELLS)
def test_reference_matches_the_plain_path_at_float64(cell, tmp_path):
    run, want = program_and_reference(cell, tmp_path, "fp64", reference.F64)
    for s, w in zip(run.samples, want):
        if run.kind == "remap":
            for g, r in zip(s["got"], w):
                np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
                np.testing.assert_allclose(np.nan_to_num(g), np.nan_to_num(r),
                                           rtol=1e-9, atol=1e-12)
            continue
        g = s["got"]
        np.testing.assert_allclose(g["points"], w["points"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(g["velocity"], w["velocity"], rtol=1e-9,
                                   atol=1e-12)
        if "attrs" in w:
            np.testing.assert_allclose(g["attrs"], w["attrs"], rtol=1e-9,
                                       atol=1e-12)
        assert g["points"].shape[1] == traffic.n_steps(
            run.mix["trajectory"]) * int(run.mix["trajectory"]["delta_t"]) \
            // int(run.mix["trajectory"]["record_t"]) + 1


@pytest.mark.parametrize("cell", bench_support.CELLS)
def test_float32_reference_reads_as_the_plain_path(cell, tmp_path):
    """The program's float32 plain path and the reference computed in
    float32 read the same numbers against the float64 reference."""
    run, want = program_and_reference(cell, tmp_path, "fp32", reference.F64)
    mesh, snaps = harness.reference_tables(run, reference.Arith(torch.float32))
    f32 = harness.reference_answers(run, mesh, snaps,
                                    reference.Arith(torch.float32))
    prog = harness.numbers_of(run, want)
    per = [check.image_numbers(g, w) if run.kind == "remap"
           else check.trajectory_numbers(g, w) for g, w in zip(f32, want)]
    ref32 = check.worst(per)
    for key in check.load_limits(cell):
        assert prog[key] == pytest.approx(ref32[key], rel=0.05, abs=1e-8)
