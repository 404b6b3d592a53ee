"""The port's native host cell search (mops_tpu_torch.native, g++) against
brute force, mops_tpu.native and the port's cKDTree path; CellSearch's
backend choice and its cKDTree cache.

Both searches are exact 1-NN over the same float64 cell centers, so every
answer must be equal, the poles included (tests/test_mesh.py:69-81), also
on a remap's global pixel grid, where the port's copy expands its search
differently near the poles; the candidate tables are the same C++ on the
same grid.
"""

import numpy as np
import pytest
import torch

import mops_tpu as mt
import mops_tpu_torch as mtt
from mops_tpu.native import NativeCellSearch as JNative
from mops_tpu_torch import native
from mops_tpu_torch.from_jax import mesh_from_jax

torch.set_num_threads(1)


def _queries(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 3))
    q = q / np.linalg.norm(q, axis=1, keepdims=True) * mt.EARTH_RADIUS
    poles = np.array([[0.0, 0.0, mt.EARTH_RADIUS],
                      [0.0, 0.0, -mt.EARTH_RADIUS]])
    return np.concatenate([q, poles])


@pytest.mark.parametrize("kind", ["voronoi", "gradient"])
def test_native_equals_brute_force_jax_and_kdtree(mesh, kind):
    jmesh = mesh if kind == "voronoi" else mt.synth.build_gradient_mesh(
        900, n_layers=4)
    pmesh = mesh_from_jax(jmesh)
    xyz = np.asarray(jmesh.cell_xyz)
    q = _queries(4000, 9)
    got = native.NativeCellSearch(xyz).query(q)
    expected = np.argmin(((q[:, None] - xyz[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, JNative(xyz).query(q))
    search = mtt.CellSearch(pmesh)
    assert search.backend == "native"
    np.testing.assert_array_equal(search.query(q), got)
    kd = mtt.CellSearch(pmesh, prefer_native=False)
    assert kd.backend == "kdtree"
    np.testing.assert_array_equal(kd.query(torch.from_numpy(q)), got)


@pytest.mark.parametrize("n_lat,n_lon", [(0, 0), (5, 16), (12, 7), (40, 80)])
def test_global_image_grid_equals_brute_force(mesh, n_lat, n_lon):
    """A remap's pixel grid, pole rows included (every pixel of the top
    and bottom rows is a pole), on the default, odd and sparse bucket
    grids (40 x 80 buckets hold about 0.16 cells each, so the search
    expands over many buckets)."""
    from mops_tpu_torch import remap
    vis = mtt.VisualizationSettings(image_width=181, image_height=91)
    pix = remap._pixel_positions(vis)
    xyz = np.asarray(mesh.cell_xyz)
    got = native.NativeCellSearch(xyz, n_lat, n_lon).query(pix)
    d2 = ((pix[:, None] - xyz[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got, np.argmin(d2, axis=1))
    np.testing.assert_array_equal(got, JNative(xyz, n_lat, n_lon).query(pix))


@pytest.mark.parametrize("shape", [(0, 0), (6, 12)])
def test_candidate_table_equals_jax(mesh, shape):
    xyz = np.asarray(mesh.cell_xyz)
    port = native.NativeCellSearch(xyz, *shape)
    ref = JNative(xyz, *shape)
    assert (port.n_lat, port.n_lon) == (ref.n_lat, ref.n_lon)
    for depth in (0, 64):
        np.testing.assert_array_equal(port.candidate_table(depth),
                                      ref.candidate_table(depth))


def test_kdtree_cache_round_trip(mesh, tmp_path):
    pmesh = mesh_from_jax(mesh)
    first = mtt.CellSearch(pmesh, prefer_native=False,
                           cache_dir=str(tmp_path / "kd"))
    files = list((tmp_path / "kd").glob("kdtree_*.pkl"))
    assert len(files) == 1
    again = mtt.CellSearch(pmesh, prefer_native=False,
                           cache_dir=str(tmp_path / "kd"))
    q = _queries(500, 3)
    np.testing.assert_array_equal(again.query(q), first.query(q))
    assert list((tmp_path / "kd").glob("kdtree_*.pkl")) == files
    # the native search takes no tree, so it writes none
    native_dir = tmp_path / "native"
    assert mtt.CellSearch(pmesh, cache_dir=str(native_dir)).backend \
        == "native"
    assert not native_dir.exists()


def test_without_a_compiler_cellsearch_takes_the_kdtree(mesh, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", "no-such-compiler-on-path")
    assert native.build() is None and native.load() is None
    with pytest.raises(RuntimeError, match="did not build"):
        native.NativeCellSearch(np.asarray(mesh.cell_xyz))
    search = mtt.CellSearch(mesh_from_jax(mesh))
    assert search.backend == "kdtree"
    q = _queries(300, 5)
    np.testing.assert_array_equal(search.query(q),
                                  mt.CellSearch(mesh).query(q))
    assert not (tmp_path / "build").exists()


def test_build_is_cached_outside_the_source_tree(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.build()
    assert path is not None and path.parent == tmp_path
    assert path.name.startswith("libmops_host_")
    assert native.build() == path                     # a cache hit
    assert not list(native.SOURCE.parent.glob("*.so"))
