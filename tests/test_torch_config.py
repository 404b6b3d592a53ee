"""The port's small modules against mops_tpu's: config.precision,
synth.solid_body_normal_velocity (equal arrays, and the port's RBF
preprocessing from its own normal velocity at test_torch_modules.py's
1e-12 relative tolerance), utils.scoped_stderr_silence and
version_string."""

import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt

torch.set_num_threads(1)


def _close(port, ref, rtol=1e-12):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = float(np.nanmax(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("mode", ["fp64", "fp32"])
def test_precision_matches_jax(mode):
    got, ref = mtt.precision(mode), mt.precision(mode)
    assert got.name == ref.name and got.is_x64 == ref.is_x64
    for f in ("real", "depth", "index"):
        assert str(getattr(got, f)).split(".")[-1] == \
            np.dtype(getattr(ref, f)).name, f
    assert got.depth == torch.float32
    with pytest.raises(ValueError, match="unknown precision mode"):
        mtt.precision("fp16")


@pytest.mark.parametrize("kind", ["voronoi", "gradient"])
def test_solid_body_normal_velocity_equals_jax(kind):
    build = f"build_{kind}_mesh"
    jmesh = getattr(mt.synth, build)(400, n_layers=5)
    pmesh = getattr(mtt.synth, build)(400, n_layers=5)
    got = mtt.synth.solid_body_normal_velocity(pmesh, n_layers=5,
                                               omega=2e-5, omega_decay=0.7)
    np.testing.assert_array_equal(got, mt.synth.solid_body_normal_velocity(
        jmesh, n_layers=5, omega=2e-5, omega_decay=0.7))
    # the port's RBF path from its own normal velocity
    raw = dict(mtt.synth.solid_body_fields(pmesh, n_layers=5))
    del raw["velocityZonal"], raw["velocityMeridional"]
    raw["normalVelocity"] = got
    ref = mt.preprocess(jmesh, raw)
    port = mtt.preprocess(pmesh, raw, device="cpu")
    _close(port.cell_velocity, ref.cell_velocity)


def test_scoped_stderr_silence(capfd):
    import os
    import sys
    from mops_tpu_torch.utils import scoped_stderr_silence
    with scoped_stderr_silence():
        os.write(sys.stderr.fileno(), b"native noise\n")
        print("python noise", file=sys.stderr)
    os.write(sys.stderr.fileno(), b"after\n")
    assert capfd.readouterr().err == "after\n"


def test_version_string_matches_jax():
    assert mtt.__version__ == mt.__version__
    assert mtt.version_string() == mt.version_string()
    assert mtt.version_string().startswith(mtt.__version__ + "+g")
