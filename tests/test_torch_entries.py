"""The port's entries on the CPU: the bench (``python -m
mops_tpu_torch.bench``) and its gate, the BASELINE configs
(``mops_tpu_torch.scripts.baseline_configs``) and the tutorials
(``mops_tpu_torch.tutorials``), held to mops_tpu where the JAX package has
the same workload.

Configs 1 and 2 run at ``--small`` with a day cut to 20 minutes and an
hour to 10 (the module's ONE_DAY and ONE_HOUR patched), float64, against mops_tpu's run of
the same workload at x64 (``use_pallas=False``): final positions within
1e-6 m (float64 summation order only).  The streamline tutorial's VTP
equals the JAX tutorial's at fp64 within 1e-6 m; the other three write
their files.  Every entry raises without a card unless it is given
``--device cpu``, and importing them brings in neither jax nor mops_tpu.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu_torch import advect, bench
from mops_tpu_torch.scripts import baseline_configs as bc
from mops_tpu_torch.scripts import bench_refscale as rs
from mops_tpu_torch.tutorials import pathline, regrid, remapping, streamline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def test_bench_json_line_and_path(monkeypatch, capsys):
    for k, v in dict(BENCH_CELLS="1500", BENCH_LAYERS="8",
                     BENCH_PARTICLES="256", BENCH_STEPS="6",
                     BENCH_REGIME="crossing").items():
        monkeypatch.setenv(k, v)
    out = bench.main(["--device", "cpu"])
    captured = capsys.readouterr()
    rec = json.loads(captured.out.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "verified", "path"}
    assert rec["metric"] == "particle_rk4_steps_per_s" and rec["value"] > 0
    assert rec["unit"] == "steps/s" and rec["vs_baseline"] == 1.0
    assert rec["verified"] is True
    assert rec["path"] == advect.LAST_RESOLVED
    assert set(rec["path"]) == {"kernel", "window", "n_window", "pathline",
                                "n_attrs", "dtype", "instance"}
    assert (rec["path"]["kernel"], rec["path"]["dtype"],
            rec["path"]["instance"]) == ("k1", "float32", "64")
    assert out["gate"]["share"] == 1.0 and out["gate"]["lanes"] == 256
    assert "# gate: lanes=256" in captured.err
    assert "roofline: not measured" in captured.err


def test_gate_fails_a_path_that_does_not_move(monkeypatch):
    """The lockstep gate against a kernel path whose positions never move
    (its step returns the start positions): the medians part, so it fails;
    the same gate on the real step passes with no lane off."""
    mesh, sol, seeds, cells = bench.build_case(1500, 8, 128, device="cpu",
                                               **bench.CROSSING)
    cfg = mtt.TrajectorySettings(
        delta_t=120, simulation_duration=120 * 40, record_t=120 * 40,
        particle_depths=mtt.seeding.linear_depth_profile(128, 10, 2500),
        fail_mode=mtt.FailMode.ZERO)
    good = bench.gate(mesh, sol, seeds, cells, cfg, device="cpu")
    assert good["verified"] and good["off"] == 0 and good["tie_flips"] == 0
    assert good["path"]["kernel"] == "k1"
    step = advect.fused_streamline_step

    def stuck(pos, *args, **kw):
        out = step(pos, *args, **kw)
        return (pos.clone(),) + tuple(out[1:])
    monkeypatch.setattr(advect, "fused_streamline_step", stuck)
    bad = bench.gate(mesh, sol, seeds, cells, cfg, device="cpu")
    assert not bad["verified"] and bad["disp_kernel_m"] < 1.0
    assert bad["off"] > 0 and bad["tie_flips"] == 0
    # the criterion alone: a path that never moves, and one whose share
    # falls below the float32 share
    s = torch.as_tensor(seeds, dtype=torch.float64)
    moved = s + 1e4
    assert not bench.gate_check(s, moved, s, torch.float32)["verified"]
    off = moved.clone()
    off[:2] += 5e3                         # 2 of 128 lanes off: 98.4 %
    res = bench.gate_check(off, moved, s, torch.float32)
    assert res["off"] == 2 and not res["verified"]
    assert bench.gate_check(moved, moved, s, torch.float32)["verified"]


def _jax_config(n_cells, n_layers, seeds, cfg, back_omega=None):
    """The JAX script's case at float64: raw fields rounded to float32 as
    the script's, the plain x64 step."""
    mesh = mt.synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=0,
                                       n_layers=n_layers)

    def snap(**kw):
        raw = mt.synth.solid_body_fields(mesh, n_layers=n_layers,
                                         w_scale=1e-5, **kw)
        return mt.preprocess(mesh, {k: np.asarray(v, np.float32).astype(
            np.float64) for k, v in raw.items()})
    back = None if back_omega is None else snap(omega=back_omega)
    cells = mt.CellSearch(mesh).query(seeds)
    return mt.run_advection(mesh, snap(), seeds.astype(np.float32).astype(
        np.float64), cells, cfg, back=back, use_pallas=False).final_position


@pytest.mark.parametrize("config", [1, 2])
def test_config_matches_jax(monkeypatch, config):
    monkeypatch.setattr(bc, "ONE_DAY", 1200)
    monkeypatch.setattr(bc, "ONE_HOUR", 600)
    rec, final = bc.CONFIGS[config](True, "cpu", F64)
    if config == 1:
        seeds = mt.seeding.generate_sample_points(mt.SamplingSettings(
            sample_range=(11, 11), lat_range=(20, 50), lon_range=(-80, -50),
            depth=10.0))
        cfg = mt.TrajectorySettings(delta_t=120, simulation_duration=1200,
                                    record_t=120, depth=10.0,
                                    fail_mode=mt.FailMode.ZERO)
        ref = _jax_config(2000, 10, seeds, cfg)
    else:
        seeds = mt.seeding.generate_gaussian_points(
            mt.SamplingSettings(lat_range=(18.0, 31.0),
                                lon_range=(-98.0, -80.0)),
            1000, mean_lat=25.0, mean_lon=-90.0, std_dev=3.0, seed=7)
        cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=7 * 1200,
                                    record_t=6 * 600, depth=50.0,
                                    fail_mode=mt.FailMode.ZERO)
        ref = _jax_config(2000, 20, seeds, cfg, back_omega=1.2e-5)
    assert rec["particles"] == len(seeds) and rec["steps"] == cfg.n_steps
    np.testing.assert_allclose(final.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    assert float(np.median(np.linalg.norm(final.numpy() - seeds,
                                          axis=1))) > 1e3


def _vtp_points(path):
    text = open(path).read()
    head = re.search(r'NumberOfPoints="(\d+)" NumberOfLines="(\d+)"', text)
    body = text.split("<Points>")[1].split(">", 1)[1].split("</DataArray>")[0]
    pts = np.array(body.split(), dtype=np.float64).reshape(-1, 3)
    assert len(pts) == int(head.group(1))
    return pts, int(head.group(2))


def test_streamline_tutorial_matches_jax(tmp_path, monkeypatch):
    """Both tutorials at fp64 on a 1,000-cell mesh for half an hour
    (ONE_DAY patched to 1800 s: 30 steps at dt 1 min)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tutorial_streamline", os.path.join(REPO, "tutorials",
                                                "streamline.py"))
    jax_tut = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tut)
    monkeypatch.setattr(mt, "ONE_DAY", 1800)
    monkeypatch.setattr(streamline, "ONE_DAY", 1800)
    want = str(tmp_path / "jax.vtp")
    monkeypatch.setattr(sys, "argv", ["streamline", "--synthetic", "1000",
                                      "--days", "1", "--out", want])
    jax_tut.main()
    got = str(tmp_path / "port.vtp")
    lines = streamline.main(["--synthetic", "1000", "--days", "1", "--out",
                             got, "--device", "cpu"])
    pts_g, n_g = _vtp_points(got)
    pts_w, n_w = _vtp_points(want)
    assert n_g == n_w == len(lines) and pts_g.shape == pts_w.shape
    assert pts_g.shape[0] == n_g * (30 // 6 + 1)
    np.testing.assert_allclose(pts_g, pts_w, rtol=0, atol=1e-6)


def test_other_tutorials_write_their_files(tmp_path):
    j = lambda name: str(tmp_path / name)
    lines = pathline.main(["--synthetic", "1000", "--grid", "4", "--pairs",
                           "2", "--hours", "6", "--out", j("pathline.vtp"),
                           "--device", "cpu"])
    imgs = remapping.main(["--synthetic", "1000", "--size", "90x45",
                           "--out", j("remap"), "--device", "cpu"])
    img = regrid.main(["--synthetic", "1000", "--width", "60", "--out",
                       j("regrid"), "--device", "cpu"])
    for name in ("pathline.vtp", "pathline.bin", "remap_east.png",
                 "remap_north.png", "remap_speed.png", "remap.vti",
                 "regrid_east.png", "regrid_north.png"):
        assert os.path.getsize(j(name)) > 0, name
    pts, n_lines = _vtp_points(j("pathline.vtp"))
    # two pairs of 6 h at a record every 6 h: the seed, each pair's end
    assert n_lines == len(lines) and len(pts) == n_lines * 3
    assert imgs[0].shape == (45, 90, 3) and img.shape == (20, 60, 3)
    assert np.isfinite(imgs[0]).any() and np.isfinite(img).any()


ENTRIES = {
    "bench": lambda: bench.main([]),
    "bench_refscale": lambda: rs.main(["A"]),
    "baseline_configs": lambda: bc.main(["1"]),
    "streamline": lambda: streamline.main([]),
    "pathline": lambda: pathline.main([]),
    "remapping": lambda: remapping.main([]),
    "regrid": lambda: regrid.main([]),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_needs_a_card_or_device_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry would run on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ENTRIES[entry]()


def test_entries_import_no_jax():
    code = (
        "import sys\n"
        "import mops_tpu_torch.bench, mops_tpu_torch.oracle\n"
        "import mops_tpu_torch.oracle.refbin\n"
        "import mops_tpu_torch.scripts.bench_refscale\n"
        "import mops_tpu_torch.scripts.baseline_configs\n"
        "import mops_tpu_torch.tutorials.streamline\n"
        "import mops_tpu_torch.tutorials.pathline\n"
        "import mops_tpu_torch.tutorials.remapping\n"
        "import mops_tpu_torch.tutorials.regrid\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'mops_tpu' or m.startswith('mops_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
