"""The multi-process form (mops_tpu_torch.parallel.distributed) on the CPU
over gloo.

Two worker processes run ``python -m mops_tpu_torch.parallel.dist_smoke
--device cpu --world 2 --per-rank 2`` (scripts/dist_smoke.py's inputs) and
check themselves; rank 0 saves what it gathered, and this process holds it
against the port's single-process runs (bit for bit: every particle sees
the same operations on the same values) and against mops_tpu's
run_advection on the same numpy inputs (test_torch_parallel.py's
tolerances: positions 1e-6 m, velocities 1e-10 m/s).  The workers never
import jax.  The device and backend rules are checked with the card
stubbed, before any group is made; a one-rank gloo group in this process
drives the cross-rank exchange and the gathers.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu_torch.from_jax import mesh_from_jax
from mops_tpu_torch.parallel import (distributed, exchange_blocks,
                                     gather_migrating, gather_trajectories,
                                     init_distributed, rank_bounds,
                                     run_advection_migrating)
from mops_tpu_torch.parallel import dist_smoke
from mops_tpu_torch.utils.subproc import free_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The 2-rank run: (completed process, rank 0's saved arrays)."""
    out = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "mops_tpu_torch.parallel.dist_smoke",
         "--device", "cpu", "--world", "2", "--per-rank", "2",
         "--port", str(free_port()), "--out", str(out),
         "--timeout", "110"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    path = out / "dist_smoke_rank0.npz"
    saved = dict(np.load(path)) if path.exists() else None
    return proc, saved


@pytest.fixture(scope="module")
def inputs():
    return dist_smoke.inputs("cpu")


def test_two_ranks_pass(smoke):
    proc, saved = smoke
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "dist_smoke: PASS" in proc.stdout
    for r in (0, 1):
        assert f"[rank {r}/2] devices ['cpu', 'cpu'], transport gloo" \
            in proc.stdout
        assert f"[rank {r}/2] mismatched local counts raised" in proc.stdout
    assert saved is not None


@pytest.mark.parametrize("n", [64, 63])
def test_sharded_rows_equal_single_process_and_jax(smoke, inputs, n):
    _, saved = smoke
    mesh, sol, seeds, cells, cfg = inputs
    single = mtt.run_advection(mesh, sol, seeds[:n], cells[:n], cfg,
                               device="cpu")
    for f in ("points", "velocities", "final_position", "final_depth",
              "alive"):
        np.testing.assert_array_equal(saved[f"sharded{n}_{f}"],
                                      getattr(single, f).numpy(), err_msg=f)
    jmesh = mt.synth.build_voronoi_mesh(dist_smoke.N_CELLS, jitter=0.05,
                                        seed=0, n_layers=dist_smoke.N_LAYERS)
    for f in ("cell_xyz", "vertices_on_cell", "cells_on_cell"):
        np.testing.assert_array_equal(getattr(mesh_from_jax(jmesh), f),
                                      getattr(mesh, f), err_msg=f)
    jsol = mt.preprocess(jmesh, mt.synth.solid_body_fields(
        jmesh, n_layers=dist_smoke.N_LAYERS, w_scale=1e-4))
    jcfg = mt.TrajectorySettings(
        delta_t=cfg.delta_t, simulation_duration=cfg.simulation_duration,
        record_t=cfg.record_t, depth=cfg.depth, fail_mode=mt.FailMode.ZERO)
    ref = mt.run_advection(jmesh, jsol, seeds[:n], cells[:n], jcfg,
                           use_pallas=False)
    np.testing.assert_allclose(saved[f"sharded{n}_points"],
                               np.asarray(ref.points), rtol=0, atol=1e-6)
    np.testing.assert_allclose(saved[f"sharded{n}_velocities"],
                               np.asarray(ref.velocities), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(saved[f"sharded{n}_final_position"],
                               np.asarray(ref.final_position), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(saved[f"sharded{n}_alive"],
                                  np.asarray(ref.alive))


def _migrating_cfg(cfg):
    return dataclasses.replace(
        cfg, simulation_duration=cfg.delta_t * dist_smoke.MIGRATE_STEPS)


def test_two_rank_migrating_equals_in_process(smoke, inputs):
    _, saved = smoke
    mesh, sol, seeds, cells, cfg = inputs
    local = run_advection_migrating(mesh, sol, seeds, cells,
                                    _migrating_cfg(cfg), devices=CPU4,
                                    capacity_factor=4.0, dtype=mesh.dtype)
    for f in dataclasses.fields(local):
        val = getattr(local, f.name)
        assert (val is None) == (f"migrating_{f.name}" not in saved), f.name
        if val is not None:
            np.testing.assert_array_equal(saved[f"migrating_{f.name}"],
                                          val.numpy(), err_msg=f.name)
    assert int(local.migrated.sum()) > 0 and int(local.dropped.sum()) == 0


@pytest.fixture
def card(monkeypatch):
    """One stubbed card; init_process_group records instead of joining."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Card X")
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    return calls


def test_nccl_two_ranks_on_one_card_raise_before_a_group(card):
    url = "tcp://localhost:1"
    for kw in ({}, {"backend": "nccl"}, {"devices": ["cuda:0"]},
               {"backend": "nccl", "devices_per_rank": 4}):
        with pytest.raises(RuntimeError, match=r"NCCL cannot put two ranks "
                           r"on one card: 2 ranks .* has 1 \(Card X\); "
                           r"pass backend='gloo'"):
            init_distributed(url, 2, 1, **kw)
    assert card == [] and not dist.is_initialized()


def test_backend_and_device_rules(card):
    url = "tcp://localhost:1"
    _, devs = init_distributed(url, 2, 1, backend="gloo")
    assert devs == [torch.device("cuda", 0)] and card[-1][0] == "gloo"
    _, devs = init_distributed(url, 1, 0, devices_per_rank=8)
    assert devs == [torch.device("cuda", 0)] * 8 and card[-1][0] == "nccl"
    assert card[-1][1] == {"init_method": url, "world_size": 1, "rank": 0}
    _, devs = init_distributed(url, 2, 0, device="cpu", devices_per_rank=3)
    assert devs == [torch.device("cpu")] * 3 and card[-1][0] == "gloo"
    for kw, err in (({"device": "cpu", "backend": "nccl"}, "NCCL needs"),
                    ({"devices": ["cpu", "cuda:0"]}, "mix the CPU"),
                    ({"backend": "mpi"}, "unknown backend"),
                    ({"devices": []}, "at least one device")):
        with pytest.raises(ValueError, match=err):
            init_distributed(url, 1, 0, **kw)
    with pytest.raises(ValueError, match="rank 2 outside"):
        init_distributed(url, 2, 2)
    assert len(card) == 3


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_distributed("tcp://localhost:1", 1, 0)
    assert not dist.is_initialized()


@pytest.fixture
def one_rank():
    group, devices = init_distributed(
        f"tcp://localhost:{free_port()}", 1, 0, device="cpu")
    yield group
    dist.destroy_process_group()


def test_one_rank_group_transport_and_gathers(one_rank, inputs):
    group = one_rank
    assert distributed.transport(group, "cpu") == "gloo"
    assert not distributed.staged(group, "cpu")
    assert rank_bounds(5, group) == (0, 5)
    send = torch.arange(24.0).view(1, 2, 3, 4)
    assert torch.equal(exchange_blocks(send, group), send)
    with pytest.raises(ValueError, match="2 send blocks for 1 ranks"):
        exchange_blocks(torch.zeros(2, 3), group)

    mesh, sol, seeds, cells, cfg = inputs
    single = mtt.run_advection(mesh, sol, seeds, cells, cfg, device="cpu")
    raw = mtt.run_advection(mesh, sol, seeds, cells, cfg, device="cpu",
                            group=group)
    whole = gather_trajectories(raw, len(seeds), group)
    for f in dataclasses.fields(single):
        a, b = getattr(whole, f.name), getattr(single, f.name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))

    mcfg = _migrating_cfg(cfg)
    kw = dict(capacity_factor=4.0, dtype=mesh.dtype)
    local = run_advection_migrating(mesh, sol, seeds, cells, mcfg,
                                    devices=CPU4, **kw)
    ranked = gather_migrating(run_advection_migrating(
        mesh, sol, seeds, cells, mcfg, devices=CPU4, group=group, **kw),
        group)
    for f in dataclasses.fields(local):
        a, b = getattr(ranked, f.name), getattr(local, f.name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
