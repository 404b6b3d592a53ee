"""The port's remap (fixed depth, fixed layer, fixed latitude) against
``mops_tpu.remap`` at float64 on the same mesh, fields and image geometry.

Meshes: the quasi-uniform Voronoi sphere, the variable-resolution gradient
mesh (K = 11) and a Voronoi sphere with a land box (pixels over land and
below the bottom come out NaN).  Tolerance: NaN masks equal, values within
1e-9 of each image's largest magnitude (float64 summation order only).
Chunked evaluation must equal the unchunked image exactly.
"""

import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu_torch import remap as premap
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax

torch.set_num_threads(1)

W, H = 64, 32
REL = 1e-9
KINDS = ["voronoi", "gradient", "land"]


def _build(kind):
    if kind == "voronoi":
        return mt.synth.build_voronoi_mesh(1000, n_layers=6)
    if kind == "gradient":
        return mt.synth.build_gradient_mesh(2000, n_layers=6)
    return mt.synth.build_voronoi_mesh(1000, n_layers=6, jitter=0.05, seed=3,
                                       land_box=(-20.0, 20.0, 0.0, 60.0))


@pytest.fixture(scope="module")
def fields():
    """kind -> (JAX Field, port Field on the CPU); the crossing-regime
    bathymetry, so columns differ in depth."""
    out = {}
    for kind in KINDS:
        mesh = _build(kind)
        raw = mt.synth.solid_body_fields(mesh, n_layers=6, w_scale=1e-4,
                                         bathymetry_amp=0.5, shelf_lon=0.3)
        sol = mt.preprocess(mesh, raw)
        out[kind] = (mt.field.Field(mesh, sol),
                     mtt.Field(mesh_from_jax(mesh), solution_from_jax(sol),
                               device="cpu"))
    return out


def _vis(mod, **kw):
    return mod.VisualizationSettings(**{"image_width": W, "image_height": H,
                                        **kw})


def _assert_image_close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    scale = np.nanmax(np.abs(ref)) if np.isfinite(ref).any() else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * scale)


@pytest.mark.parametrize("depth", [100.0, 1200.0, 2500.0])
@pytest.mark.parametrize("depth_accurate", [False, True],
                         ids=["quirk", "accurate"])
@pytest.mark.parametrize("kind", KINDS)
def test_fixed_depth_matches_jax(fields, kind, depth_accurate, depth):
    jf, pf = fields[kind]
    ref = mt.remap.run_remapping(jf, _vis(mt, fixed_depth=depth),
                                 depth_accurate=depth_accurate)
    got = premap.run_remapping(pf, _vis(mtt, fixed_depth=depth),
                               depth_accurate=depth_accurate)
    assert len(got) == len(ref) == 2          # velocity + one attr group
    for g, r in zip(got, ref):
        _assert_image_close(g, r)
    u, v, s = got[0][..., 0], got[0][..., 1], got[0][..., 2]
    np.testing.assert_allclose(s, np.hypot(u, v), rtol=1e-12)
    if kind == "land":
        assert np.isnan(got[0]).any() and np.isfinite(got[0]).any()


def test_layer0_quirk_changes_the_image(fields):
    """The reference's layer-0 override (default) averages layers 0/1 at
    any depth below the surface; at 2500 m the scan's layer differs."""
    _, pf = fields["voronoi"]
    cfg = _vis(mtt, fixed_depth=2500.0)
    quirk = premap.run_remapping(pf, cfg)[0]
    accurate = premap.run_remapping(pf, cfg, depth_accurate=True)[0]
    ocean = np.isfinite(quirk) & np.isfinite(accurate)
    assert ocean.any()
    assert np.abs(quirk[ocean] - accurate[ocean]).max() > 1e-6 * np.abs(
        quirk[ocean]).max()


def test_attr_fanout_matches_jax(mesh, raw_fields):
    """Four attributes -> two three-channel groups in name order, unused
    channels zero (reference src/Core/MOPSApp.cpp:176-185; the case of
    tests/test_api.py::test_remapping_attr_fanout)."""
    raw = {k: np.asarray(v) for k, v in raw_fields.items()}
    raw["oxygen"] = raw["temperature"] * 0.1 + 1.0
    raw["nitrate"] = raw["temperature"] * 0.2 + 2.0
    sol = mt.preprocess(mesh, raw)
    jf = mt.field.Field(mesh, sol)
    pf = mtt.Field(mesh_from_jax(mesh), solution_from_jax(sol), device="cpu")
    ref = mt.remap.run_remapping(jf, _vis(mt, fixed_depth=100.0))
    got = premap.run_remapping(pf, _vis(mtt, fixed_depth=100.0))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _assert_image_close(g, r)
    ocean = np.isfinite(got[2][..., 0])
    assert ocean.any()
    assert np.all(got[2][..., 1:][ocean] == 0.0)
    assert np.nanmax(got[2][..., 0]) > 1.0


@pytest.mark.parametrize("chunk", [500, 2048 - 1])
@pytest.mark.parametrize("entry", ["depth", "layer", "regrid"])
def test_chunked_equals_unchunked(fields, entry, chunk):
    """Chunks smaller than the image (a padded tail of cell -1 pixels)
    give exactly the unchunked image."""
    _, pf = fields["land"]
    if entry == "depth":
        def run(c):
            return premap.run_remapping(pf, _vis(mtt, fixed_depth=100.0),
                                        chunk=c)
    elif entry == "layer":
        def run(c):
            return [premap.run_fixed_layer(pf, _vis(mtt, fixed_layer=2),
                                           chunk=c)]
    else:
        def run(c):
            return [premap.run_regrid(
                pf, _vis(mtt, image_height=H, fixed_latitude=10.0), chunk=c)]
    whole, parts = run(0), run(chunk)
    assert (W * H) % chunk
    for a, b in zip(parts, whole):
        np.testing.assert_array_equal(a, b)


def test_remap_chunk_resolution(monkeypatch):
    assert premap.resolve_remap_chunk(123, 10) == 123
    monkeypatch.setenv("MOPS_REMAP_CHUNK", "77")
    assert premap.resolve_remap_chunk(None, 10) == 77
    monkeypatch.delenv("MOPS_REMAP_CHUNK")
    assert premap.resolve_remap_chunk(None, 10) \
        == mt.remap.resolve_remap_chunk(None, 10) == 262144


@pytest.mark.parametrize("layer", [0, 3, 99])
@pytest.mark.parametrize("kind", KINDS)
def test_fixed_layer_matches_jax(fields, kind, layer):
    jf, pf = fields[kind]
    ref = mt.remap.run_fixed_layer(jf, _vis(mt, fixed_layer=layer))
    got = premap.run_fixed_layer(pf, _vis(mtt, fixed_layer=layer))
    _assert_image_close(got, ref)
    assert np.all(got[..., 2][np.isfinite(got[..., 2])] == 0.0)


@pytest.mark.parametrize("lat", [20.0, -35.0, 5.0])
@pytest.mark.parametrize("kind", KINDS)
def test_regrid_matches_jax(fields, kind, lat):
    """A depth x longitude section over refBottomDepth (the synth meshes
    carry it)."""
    jf, pf = fields[kind]
    cfg = dict(image_height=6, fixed_latitude=lat, lon_range=(-60.0, 90.0))
    ref = mt.remap.run_regrid(jf, _vis(mt, **cfg))
    got = premap.run_regrid(pf, _vis(mtt, **cfg))
    _assert_image_close(got, ref)
    assert np.isfinite(got).any()


def test_regrid_requires_ref_bottom_depth(fields):
    _, pf = fields["voronoi"]
    import dataclasses
    bare = mtt.Field(dataclasses.replace(pf.mesh, ref_bottom_depth=None),
                     pf.front, device="cpu")
    with pytest.raises(ValueError, match="refBottomDepth"):
        premap.run_regrid(bare, _vis(mtt, image_height=6))


def test_is_land_sign_test_matches_jax(fields):
    """The reference's sign-consistency land test on a land-box mesh, and
    Field.is_on_land, against JAX on the same points."""
    import jax.numpy as jnp
    jf, pf = fields["land"]
    rng = np.random.default_rng(11)
    lat = np.deg2rad(rng.uniform(-40, 40, 600))
    lon = np.deg2rad(rng.uniform(-30, 90, 600))
    pts = np.array(mt.geo.latlon_rad_to_xyz(lat, lon))
    cells = jf.search.query(pts)
    ref = np.asarray(mt.remap._is_land_sign_test(
        jf.mesh, jnp.asarray(pts), jnp.asarray(cells)))
    got = premap._is_land_sign_test(pf.mesh, torch.from_numpy(pts),
                                    torch.from_numpy(cells)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.any() and not ref.all()
    for p in pts[:12]:
        assert pf.is_on_land(p) == jf.is_on_land(p)


def test_geo_pixel_and_enu_match_jax():
    i, j = np.meshgrid(np.arange(5.0), np.arange(7.0), indexing="ij")
    args = (7, 5, -80.0, 70.0, -170.0, 160.0)
    for port, ref in zip(
            mtt.geo.pixel_to_latlon_rad(torch.from_numpy(i),
                                        torch.from_numpy(j), *args),
            mt.geo.pixel_to_latlon_rad(i, j, *args)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-15)
    rng = np.random.default_rng(3)
    p = rng.normal(size=(64, 3)) * 6e6
    p[0] = [0.0, 0.0, 6e6]                                  # the pole
    v = rng.normal(size=(64, 3))
    for port, ref in zip(mtt.geo.xyz_velocity_to_enu(torch.from_numpy(p),
                                                     torch.from_numpy(v)),
                         mt.geo.xyz_velocity_to_enu(p, v)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-14)


def test_weighted_vertex_value_matches_jax(mesh, sol):
    import jax.numpy as jnp
    from mops_tpu_torch.step import _weighted_vertex_value
    rng = np.random.default_rng(5)
    n, K = 40, mesh.max_edges
    vids = rng.integers(0, mesh.n_vertices, size=(n, K)).astype(np.int32)
    layer = rng.integers(0, 6, size=n).astype(np.int32)
    w = rng.uniform(size=(n, K))
    for table in (sol.vertex_ztop, sol.vertex_velocity):
        ref = mt.advect._weighted_vertex_value(
            jnp.asarray(table), jnp.asarray(vids), jnp.asarray(layer),
            jnp.asarray(w))
        got = _weighted_vertex_value(torch.from_numpy(np.array(table)),
                                     torch.from_numpy(vids),
                                     torch.from_numpy(layer),
                                     torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)
