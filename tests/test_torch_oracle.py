"""The port's own oracle (mops_tpu_torch.oracle, NumPy only) against
mops_tpu.oracle, and the port's plain float64 path against it.

- The copy equals mops_tpu.oracle bit for bit on the same inputs (the JAX
  package's mesh and fields, or the port's CPU tensors of the same values):
  the same loops over the same float64 values.
- ``run_advection(..., use_kernel=False)`` at float64 against
  ``oracle_streamline`` / ``oracle_pathline``, as tests/test_advect.py holds
  mops_tpu to its oracle, at its tolerances: positions 5e-6 m (streamline)
  and 5e-3 m (pathline: the einsum-vs-scalar-loop summation order over two
  snapshots), velocities 1e-10 m/s, attributes 1e-8, depths 1e-4 m.
- ``refbin``: the tagged file format equals mops_tpu's byte for byte; the
  compiled reference runs only where its checkout and g++ exist (neither
  does here, so those tests skip, as tests/test_golden_ref.py's).
"""

import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu.oracle import oracle as jax_oracle
from mops_tpu.oracle import refbin as jax_refbin
from mops_tpu_torch import advect
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax
from mops_tpu_torch.oracle import oracle as port_oracle
from mops_tpu_torch.oracle import refbin

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=5e-6)


def _settings(mod, **kw):
    base = dict(delta_t=600, simulation_duration=600 * 24, record_t=1200,
                depth=500.0)
    base.update(kw)
    return mod.TrajectorySettings(**base)


def _stacked(sol):
    return np.stack([np.asarray(sol.vertex_attrs[k])
                     for k in sorted(sol.vertex_attrs)], axis=-1)


@pytest.fixture(scope="module")
def port(mesh, sol, sol_back):
    return mesh_from_jax(mesh), solution_from_jax(sol), \
        solution_from_jax(sol_back)


@pytest.mark.parametrize("inputs", ["jax", "port"])
def test_streamline_oracle_equals_mops_tpu(mesh, sol, seeds, cells, port,
                                           inputs):
    want = jax_oracle.oracle_streamline(mesh, sol, seeds, cells,
                                        _settings(mt, simulation_duration=6000))
    m, s = (mesh, sol) if inputs == "jax" else port[:2]
    got = port_oracle.oracle_streamline(
        m, s, seeds, cells, _settings(mtt, simulation_duration=6000))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got[2] - seeds).max() > 1e3


@pytest.mark.parametrize("inputs", ["jax", "port"])
def test_pathline_oracle_equals_mops_tpu(mesh, sol, sol_back, seeds, cells,
                                         port, inputs):
    kw = dict(simulation_duration=6000)
    want = jax_oracle.oracle_pathline(
        mesh, sol, sol_back, seeds, cells, _settings(mt, **kw),
        attrs_f=_stacked(sol), attrs_b=_stacked(sol_back))
    m, f, b = (mesh, sol, sol_back) if inputs == "jax" else port
    got = port_oracle.oracle_pathline(
        m, f, b, seeds, cells, _settings(mtt, **kw),
        attrs_f=_stacked(f), attrs_b=_stacked(b))
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a, c)
    assert np.abs(got[2]).max() > 0


def test_scalar_helpers_equal_mops_tpu(mesh, raw_fields, sol, port):
    pm, ps, _ = port
    cell_t = np.asarray(raw_fields["temperature"])
    np.testing.assert_array_equal(
        port_oracle.oracle_preprocess(pm, cell_t, clamp_negative=True),
        jax_oracle.oracle_preprocess(mesh, cell_t, clamp_negative=True))
    normal = mt.synth.solid_body_normal_velocity(mesh, n_layers=6)
    for cell, layer in ((0, 0), (17, 3), (250, 5)):
        np.testing.assert_array_equal(
            port_oracle.oracle_rbf_cell_velocity(pm, normal, cell, layer),
            jax_oracle.oracle_rbf_cell_velocity(mesh, normal, cell, layer))
    pos = np.asarray(mesh.cell_xyz)[42] * 1.0
    for depth in (-5.0, -500.0, -3999.0):
        got = port_oracle.oracle_velocity_at(pm, ps, pos, 42, depth)
        want = jax_oracle.oracle_velocity_at(mesh, sol, pos, 42, depth)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    z = np.linspace(0.0, -4000.0, 6)
    for d in (10.0, -1.0, -2000.0, -4000.0, -5000.0):
        assert port_oracle._layer_binary(z, d) == jax_oracle._layer_binary(z, d)
        assert port_oracle._layer_linear(z, d) == jax_oracle._layer_linear(z, d)


@pytest.mark.parametrize("case", ["rk4", "euler", "backward"])
def test_plain_path_matches_port_oracle(mesh, seeds, cells, port, case):
    pm, ps, _ = port
    kw = {"rk4": {}, "euler": {"method": mtt.CalcMethod.EULER},
          "backward": {"direction": mtt.CalcDirection.BACKWARD,
                       "simulation_duration": 600 * 14}}[case]
    cfg = _settings(mtt, **kw)
    raw = mtt.run_advection(pm, ps, seeds, cells, cfg, device="cpu",
                            use_kernel=False)
    pts, vels, final, depths = port_oracle.oracle_streamline(pm, ps, seeds,
                                                             cells, cfg)
    np.testing.assert_allclose(raw.points.numpy(), pts, **TOL)
    np.testing.assert_allclose(raw.final_position.numpy(), final, **TOL)
    if case == "rk4":
        np.testing.assert_allclose(raw.velocities.numpy(), vels, atol=1e-10)
        np.testing.assert_allclose(raw.final_depth.numpy(), depths, atol=1e-4)


def test_plain_pathline_matches_port_oracle(seeds, cells, port):
    pm, pf, pb = port
    cfg = _settings(mtt, simulation_duration=600 * 14)
    raw = mtt.run_advection(pm, pf, seeds, cells, cfg, back=pb, device="cpu",
                            use_kernel=False)
    assert advect.LAST_RESOLVED["n_attrs"] == 2
    pts, vels, attrs, final, _ = port_oracle.oracle_pathline(
        pm, pf, pb, seeds, cells, cfg, attrs_f=_stacked(pf),
        attrs_b=_stacked(pb))
    np.testing.assert_allclose(raw.points.numpy(), pts, rtol=0, atol=5e-3)
    np.testing.assert_allclose(raw.final_position.numpy(), final, rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(raw.attrs.numpy(), attrs, atol=1e-8)


def test_refbin_tagged_format_equals_mops_tpu(tmp_path):
    rng = np.random.default_rng(3)
    entries = {"nCells": np.array([7]), "cellCoord": rng.normal(size=21),
               "seedCells": np.arange(5, dtype=np.int32),
               "mask": np.array([True, False])}
    refbin.write_tagged(tmp_path / "port.bin", entries)
    jax_refbin.write_tagged(tmp_path / "jax.bin", entries)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    back = refbin.read_tagged(tmp_path / "port.bin")
    assert list(back) == list(entries)
    for k, v in entries.items():
        np.testing.assert_array_equal(back[k], np.asarray(v).astype(
            back[k].dtype))
        assert back[k].dtype in (np.int64, np.float64)
    assert refbin._unnormalize(np.array([[0, -1, 4]])).tolist() == \
        [[1, 0, 5]]
    assert refbin.BUILD_DIR.name == "_build" \
        and refbin.BUILD_DIR.parent.name == "mops_tpu_torch"


@pytest.mark.parametrize("root", ["unset", "empty"])
def test_refbin_unavailable_without_the_reference(root, tmp_path,
                                                  monkeypatch):
    """No reference tree is read unless $MOPS_REFERENCE names one."""
    monkeypatch.setattr(refbin, "REF_ROOT",
                        None if root == "unset" else tmp_path)
    assert not refbin.available()
    with pytest.raises(RuntimeError, match="MOPS_REFERENCE"):
        refbin.build_driver()


@pytest.mark.skipif(not refbin.available(),
                    reason="reference tree or g++ not available")
def test_refbin_streamline_matches_port(mesh, raw_fields, seeds, cells,
                                        port):
    """The reference's compiled TBB streamline against the port's plain
    float64 path on the same cell-centre ztop (tests/test_golden_ref.py's
    tolerance)."""
    pm, _, _ = port
    z = mtt.solution.cell_center_ztop(
        torch.as_tensor(np.asarray(raw_fields["layerThickness"])),
        torch.as_tensor(np.asarray(raw_fields["bottomDepth"]))).numpy()
    ps = mtt.preprocess(pm, dict(raw_fields, zTop=z), device="cpu")
    cfg = _settings(mtt)
    ref = refbin.run_reference(pm, raw_fields, z, seeds, cells, cfg)
    raw = mtt.run_advection(pm, ps, seeds, cells, cfg, device="cpu",
                            use_kernel=False)
    np.testing.assert_allclose(raw.final_position.numpy(), ref["lastPoint"],
                               **TOL)
