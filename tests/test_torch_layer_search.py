"""The streamline layer search that K1 keeps: the port's bisection against
mops_tpu's, bit for bit, on clamped profiles with plateaus.

The exact clamp turns a run of ascending raw values (a bathymetry step, or
negative Wachspress weights outside a cell) into a plateau whose layers lie
1e-9 apart (at float32 the step rounds away and they are equal), below
EPS_LAYER = 1e-8.  A depth on such a plateau lies within EPS_LAYER of
several intervals, so the layer depends on the order in which the search
probes them: the reference's bisection (which K1 runs, probe for probe) and
the first-hit linear search (K2's) part there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mops_tpu import advect as jadvect
from mops_tpu_torch.config import EPS_LAYER
from mops_tpu_torch.step import (_clamp_profile, _layer_search_binary,
                                 _layer_search_linear)


def _plateau_case(L, dtype):
    """Clamped profiles of 600 lanes (layers 1-80 m thick, each with one
    plateau: the raw values of a run of layers set above the layer over it)
    and depths: on the plateau, on an interface, within EPS_LAYER of one,
    between layers, above the surface and below the bottom."""
    rng = np.random.default_rng(L)
    n = 600
    raw = -np.cumsum(rng.uniform(1.0, 80.0, (n, L)), axis=1)
    lane = np.arange(n)
    start = rng.integers(1, L, n)                        # plateau's first
    stop = np.minimum(start + rng.integers(1, L, n), L)  # layer past it
    for i in range(n):
        raw[i, start[i]:stop[i]] = raw[i, start[i] - 1] + 10.0
    z = _clamp_profile(torch.from_numpy(raw.astype(dtype)), True).numpy()
    on = rng.integers(start - 1, stop)                   # plateau layers
    any_l = rng.integers(0, L, n)
    depth = np.select(
        [lane % 6 == 0, lane % 6 == 1, lane % 6 == 2, lane % 6 == 3,
         lane % 6 == 4],
        [z[lane, on], z[lane, any_l],
         z[lane, any_l] + rng.uniform(-1.0, 1.0, n) * EPS_LAYER,
         rng.uniform(z[:, -1], z[:, 0]), z[:, 0] + 1.0],
        z[:, -1] - 1.0).astype(dtype)
    return z, depth


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L", [2, 3, 60, 80, 128])
def test_layer_search_binary_matches_jax_on_plateaus(L, dtype):
    z, depth = _plateau_case(L, dtype)
    if dtype == "float64":                   # plateaus 1e-9 apart, not flat
        steps = -np.diff(z, axis=1)
        assert ((steps > 0) & (steps < 2e-9)).any()
    port = _layer_search_binary(torch.from_numpy(z), torch.from_numpy(depth))
    ref = jadvect._layer_search_binary(jnp.asarray(z), jnp.asarray(depth))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    linear, ok = _layer_search_linear(torch.from_numpy(z),
                                      torch.from_numpy(depth))
    assert bool(ok.all())
    differ = linear != port
    if L <= 3:
        # at most two intervals: the bisection's first probe is interval 1,
        # the first-hit search's too
        assert not bool(differ.any())
    else:
        # lanes whose depth lies on a plateau, where the bisection stops at
        # another of the intervals that hold it
        assert bool(differ.any())
        assert bool(differ[np.arange(len(depth)) % 6 == 0].any())
