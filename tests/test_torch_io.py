"""The port's I/O (stream YAML, NetCDF reader, writers, caches), dates and
CLI against ``mops_tpu.io``, ``mops_tpu.utils.dates`` and the port's own
remap.

The stream YAML parser must give what yaml.safe_load gives, and
StreamConfig.parse the same substreams as mops_tpu's.  Writers must be
byte-equal to mops_tpu.io.image's, except: save_png, whose PNG is compared
decoded (RGBA arrays equal pixel for pixel, decoded with PIL); and
export_pathline_binary, whose lat/lon values come from the port's
arcsin/atan2 (torch) rather than XLA's, so they are held to 2 ulp while
the rest of the file is byte-equal.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
import yaml

import mops_tpu_torch as mtt
from mops_tpu.io import MPASOReader as JReader
from mops_tpu.io import NetCDFFile as JNetCDF
from mops_tpu.io import StreamConfig as JStreamConfig
from mops_tpu.io import cache as jcache
from mops_tpu.io import image as jimage
from mops_tpu.utils import dates as jdates
from mops_tpu_torch.from_jax import mesh_from_jax, solution_from_jax
from mops_tpu_torch.io import MPASOReader, NetCDFFile, StreamConfig
from mops_tpu_torch.io import cache as pcache
from mops_tpu_torch.io import image as pimage
from mops_tpu_torch.io.imagebuffer import ImageBuffer
from mops_tpu_torch.io.reader import parse_yaml
from mops_tpu_torch.utils import dates as pdates

torch.set_num_threads(1)

# tests/test_io.py's stream YAML
STREAM_YAML = """
stream:
  name: synth
  path_prefix: "{d}"
  substreams:
    - name: mesh
      format: netcdf
      filenames: "synth_mesh.nc"
      static: true
    - name: data
      format: netcdf
      filenames: "synth_*.nc"
      vars:
        - name: velocityZonal
          possible_names: [velocityZonal]
        - name: temperature
          optional: true
"""

# the same schema with comments, quoted names and flow/block lists
COMMENTED_YAML = """# MPAS-O stream (comments, quotes)
stream:   # the one stream
  name: 'soma # 32km'
  path_prefix: {d}
  substreams:
  - name: "mesh"            # static grid
    filenames: ["synth_mesh.nc", 'missing_*.nc']
    static: yes
  - name: data
    filenames:
      - synth_mesh.nc
      - "other file.nc"
    vars:
      - name: "normalVelocity"
        possible_names:
          - normalVelocity
          - 'timeMonthly_avg_normalVelocity'
        optional: false
      - name: temperature   # tracer
        optional: True
"""

MORE_YAML = [
    "a: 1\nb: -2.5\nc: ~\nd: null\ne: 1e5\nf: 017x\ng: 'it''s'\n",
    'a: "tab\\there"\nb: [1, [2, 3], "x, y", "d_{year}.nc"]\nc: [q, r]\n',
    "k:\n- 1\n- - 2\n  - 3\n-\n  x: 4\n",
    "---\nlist:\n  - a: 1\n    b: [x]\n  - c\n...\n",
    "s: value # comment\nt: 'a # kept'\nu: a#b\nv: \"q\\\"x\"\n",
]


def _write_mesh_nc3(path, mesh, raw, n_layers):
    """Mesh + one timestep in MPAS NetCDF layout via scipy (NetCDF-3), as
    tests/test_io.py writes it."""
    from scipy.io import netcdf_file
    f = netcdf_file(path, "w")
    for name, size in (("nCells", mesh.n_cells), ("nVertices",
                       mesh.n_vertices), ("nEdges", mesh.n_edges),
                       ("maxEdges", mesh.max_edges), ("vertexDegree", 3),
                       ("TWO", 2), ("nVertLevels", n_layers),
                       ("nVertLevelsP1", n_layers + 1), ("Time", 1)):
        f.createDimension(name, size)

    def put(name, dims, data, typ="d"):
        f.createVariable(name, typ, dims)[:] = data

    for pre, arr, dim in (("Cell", mesh.cell_xyz, "nCells"),
                          ("Vertex", mesh.vertex_xyz, "nVertices"),
                          ("Edge", mesh.edge_xyz, "nEdges")):
        a = np.asarray(arr)
        for k, ax in enumerate("xyz"):
            put(ax + pre, (dim,), a[:, k])
    put("nEdgesOnCell", ("nCells",), np.asarray(mesh.n_edges_on_cell), "i")

    def one_based(arr):
        a = np.asarray(arr).astype(np.int32)
        return np.where(a < 0, 0, a + 1)

    for name, arr, dims in (
            ("verticesOnCell", mesh.vertices_on_cell, ("nCells", "maxEdges")),
            ("cellsOnCell", mesh.cells_on_cell, ("nCells", "maxEdges")),
            ("cellsOnVertex", mesh.cells_on_vertex,
             ("nVertices", "vertexDegree")),
            ("edgesOnCell", mesh.edges_on_cell, ("nCells", "maxEdges")),
            ("cellsOnEdge", mesh.cells_on_edge, ("nEdges", "TWO")),
            ("verticesOnEdge", mesh.vertices_on_edge, ("nEdges", "TWO"))):
        put(name, dims, one_based(arr), "i")
    put("refBottomDepth", ("nVertLevels",), np.linspace(100, 4000, n_layers))
    put("bottomDepth", ("nCells",), raw["bottomDepth"])
    for name in ("layerThickness", "velocityZonal", "velocityMeridional",
                 "temperature"):
        put(name, ("Time", "nCells", "nVertLevels"), raw[name][None])
    put("vertVelocityTop", ("Time", "nCells", "nVertLevelsP1"),
        raw["vertVelocityTop"][None])
    xtime = np.zeros((1, 64), dtype="S1")
    xtime[0, :19] = list(b"0001-01-01_00:00:00")
    f.createDimension("StrLen", 64)
    f.createVariable("xtime", "c", ("Time", "StrLen"))[:] = xtime
    f.close()


@pytest.fixture(scope="module")
def nc_dir(tmp_path_factory, mesh, raw_fields):
    d = tmp_path_factory.mktemp("data")
    _write_mesh_nc3(str(d / "synth_mesh.nc"), mesh,
                    {k: np.asarray(v) for k, v in raw_fields.items()}, 6)
    for name, text in (("stream.yaml", STREAM_YAML),
                       ("commented.yaml", COMMENTED_YAML)):
        (d / name).write_text(text.replace("{d}", str(d)))
    return d


@pytest.mark.parametrize("name", ["stream.yaml", "commented.yaml"])
def test_stream_config_matches_jax(nc_dir, name):
    path = str(nc_dir / name)
    text = open(path).read()
    assert parse_yaml(text) == yaml.safe_load(text)
    port, ref = StreamConfig.parse(path), JStreamConfig.parse(path)
    assert (port.name, port.path_prefix) == (ref.name, ref.path_prefix)
    assert [dataclasses.asdict(s) for s in port.substreams] \
        == [dataclasses.asdict(s) for s in ref.substreams]
    other = str(nc_dir / "elsewhere")
    assert StreamConfig.parse(path, other).path_prefix \
        == JStreamConfig.parse(path, other).path_prefix == other


@pytest.mark.parametrize("case", range(len(MORE_YAML)))
def test_parse_yaml_matches_safe_load(case):
    assert parse_yaml(MORE_YAML[case]) == yaml.safe_load(MORE_YAML[case])
    if case == 0:
        with pytest.raises(ValueError, match="flow mappings"):
            parse_yaml("a: {x: 1}\n")


def test_reader_roundtrip_matches_jax(nc_dir, mesh):
    cfg_path = str(nc_dir / "stream.yaml")
    port, ref = MPASOReader(StreamConfig.parse(cfg_path)), \
        JReader(JStreamConfig.parse(cfg_path))
    pm, rm = port.read_mesh(), ref.read_mesh()
    assert isinstance(pm, mtt.MPASMesh) and pm.name == rm.name
    for f in dataclasses.fields(rm):
        a, b = getattr(pm, f.name), getattr(rm, f.name)
        if f.name == "name":
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f.name)
        assert a.numpy().dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(pm.cell_xyz.numpy(),
                                  np.asarray(mesh.cell_xyz))
    praw, rraw = port.read_solution(0), ref.read_solution(0)
    assert praw.keys() == rraw.keys() and "_timestamp" in praw
    for k in rraw:
        np.testing.assert_array_equal(praw[k], rraw[k], err_msg=k)
    assert port.locate(0) == ref.locate(0)
    with pytest.raises(IndexError):
        port.locate(5)
    sol = mtt.preprocess(pm, {k: v for k, v in praw.items()
                              if k != "_timestamp"}, device="cpu")
    assert sol.n_layers == 6


def test_netcdf_reads_match_jax(nc_dir, tmp_path, monkeypatch):
    path = str(nc_dir / "synth_mesh.nc")
    with NetCDFFile(path) as p, JNetCDF(path) as r:
        assert p.variables() == r.variables()
        assert p.dimension_size("nVertLevels") == 6
        for name in ("layerThickness", "xCell", "cellsOnCell"):
            assert p.dims(name) == r.dims(name)
            np.testing.assert_array_equal(p.read_timestep(name, 0),
                                          r.read_timestep(name, 0))
    import h5py
    h5 = str(tmp_path / "t.h5")
    with h5py.File(h5, "w") as f:
        f["xCell"] = np.arange(5.0, dtype=np.float32)
    with NetCDFFile(h5) as nc:
        assert nc.has("xCell") and nc.read("xCell").dtype == np.float64
    # without h5py only a NetCDF-4 file fails, naming the package
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        NetCDFFile(h5)
    with NetCDFFile(path) as nc:
        assert nc.has("xCell")
    with pytest.raises(ValueError):
        NetCDFFile(str(nc_dir / "stream.yaml"))


def _decoded(path):
    from PIL import Image
    with Image.open(path) as im:
        assert im.mode == "RGBA"
        return np.asarray(im)


def _channels():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(9, 13))
    img[0, 0] = img[4, 7] = np.nan
    ramp = np.linspace(0.0, 1.0, 257 * 3).reshape(3, 257)
    return {"random_nan": img, "ramp": ramp, "constant": np.full((4, 5), 2.5),
            "all_nan": np.full((3, 3), np.nan),
            "inf": np.array([[1.0, np.inf], [3.0, -2.0]])}


@pytest.mark.parametrize("case", sorted(_channels()))
def test_save_png_decodes_equal_to_jax(case, tmp_path):
    ch = _channels()[case]
    pimage.save_png(str(tmp_path / "p.png"), ch)
    jimage.save_png(str(tmp_path / "j.png"), ch)
    np.testing.assert_array_equal(_decoded(tmp_path / "p.png"),
                                  _decoded(tmp_path / "j.png"))


def test_viridis_table_is_matplotlibs():
    from matplotlib import cm
    np.testing.assert_array_equal(pimage.VIRIDIS,
                                  np.asarray(cm.viridis.colors))
    x = np.array([0.0, 1e-9, 0.5, 255.5 / 256, 1.0 - 1e-16, 1.0, -0.1, 1.5,
                  np.nan])
    np.testing.assert_array_equal(pimage.viridis_rgba(x), cm.viridis(x))


def _lines():
    rng = np.random.default_rng(3)
    out = []
    for i in range(3):
        n = 4 + i
        pts = rng.normal(size=(n, 3)) * 6e6
        out.append(mtt.TrajectoryLine(
            line_id=i, points=pts, velocity=rng.normal(size=(n, 3)),
            temperature=rng.normal(size=n), salinity=rng.normal(size=n),
            last_point=pts[-1], duration=1.0, timestamp=1.0, depth=10.0))
    return out


def test_writers_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(1)
    imgs = [rng.normal(size=(8, 12, 3)), rng.normal(size=(8, 12, 3)) * 1e-7]
    imgs[0][0, 0] = np.nan
    lines = _lines()
    for name, write in (
            ("x.vti", lambda m, p: m.save_vti(p, imgs, ["velocity", "a"])),
            ("t.vtp", lambda m, p: m.save_trajectories_vtp(p, lines)),
            ("t.txt", lambda m, p: m.save_trajectories_text(p, lines))):
        write(pimage, str(tmp_path / ("p" + name)))
        write(jimage, str(tmp_path / ("j" + name)))
        assert (tmp_path / ("p" + name)).read_bytes() \
            == (tmp_path / ("j" + name)).read_bytes(), name
    paths = pimage.save_image_channels_png(str(tmp_path / "p"), imgs[0],
                                           ("east", "north", "speed"))
    jpaths = jimage.save_image_channels_png(str(tmp_path / "j"), imgs[0],
                                            ("east", "north", "speed"))
    assert [os.path.basename(p)[1:] for p in paths] \
        == [os.path.basename(p)[1:] for p in jpaths]
    for p, j in zip(paths, jpaths):
        np.testing.assert_array_equal(_decoded(p), _decoded(j))
    buf = ImageBuffer.from_array(imgs[0])
    buf.save_png(str(tmp_path / "buf.png"), channel=1)
    np.testing.assert_array_equal(_decoded(tmp_path / "buf.png"),
                                  _decoded(paths[1]))


def test_pathline_binary_matches_jax(tmp_path):
    lines = _lines()
    pimage.export_pathline_binary(str(tmp_path / "p.bin"), lines)
    jimage.export_pathline_binary(str(tmp_path / "j.bin"), lines)
    p, j = (tmp_path / "p.bin").read_bytes(), (tmp_path / "j.bin").read_bytes()
    assert len(p) == len(j)
    head = 4 * (1 + len(lines))
    n_ll = 8 * 2 * sum(len(l.points) for l in lines)
    assert p[:head] == j[:head] and p[head + n_ll:] == j[head + n_ll:]
    np.testing.assert_array_max_ulp(
        np.frombuffer(p[head:head + n_ll], "<f8"),
        np.frombuffer(j[head:head + n_ll], "<f8"), maxulp=2)


def test_solution_cache_roundtrip(tmp_path, mesh, sol):
    pmesh = mesh_from_jax(mesh)
    psol = solution_from_jax(sol)
    path = pcache.save_solution_cache(str(tmp_path), pmesh, psol)
    assert os.path.exists(path)
    loaded = pcache.load_solution_cache(str(tmp_path), pmesh, psol.timestep)
    for f in ("cell_ztop", "vertex_ztop", "cell_velocity", "vertex_velocity",
              "vertex_vert_velocity"):
        assert torch.equal(getattr(loaded, f), getattr(psol, f)), f
    assert loaded.vertex_attrs.keys() == psol.vertex_attrs.keys()
    for k in psol.vertex_attrs:
        assert torch.equal(loaded.vertex_attrs[k], psol.vertex_attrs[k])
        assert torch.equal(loaded.cell_attrs[k], psol.cell_attrs[k])
    assert loaded.timestamp == psol.timestamp
    assert pcache.load_solution_cache(str(tmp_path), pmesh, 999) is None
    # the JAX package's cache file reads back into the port's types
    jpath = jcache.save_solution_cache(str(tmp_path / "j"), mesh, sol)
    assert os.path.basename(jpath) == os.path.basename(path)
    cross = pcache.load_solution_cache(str(tmp_path / "j"), pmesh,
                                       sol.timestep)
    assert torch.equal(cross.vertex_velocity, psol.vertex_velocity)


def test_particle_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    pos = np.random.default_rng(0).normal(size=(10, 3))
    pcache.save_particle_checkpoint(p, torch.from_numpy(pos), np.ones(10),
                                    np.arange(10), np.ones(10, bool),
                                    meta={"step": 42})
    pos2, d2, c2, a2, meta = pcache.load_particle_checkpoint(p)
    np.testing.assert_array_equal(pos2, pos)
    np.testing.assert_array_equal(c2, np.arange(10))
    assert int(meta["step"]) == 42
    ref = jcache.load_particle_checkpoint(p)
    np.testing.assert_array_equal(ref[0], pos2)


def test_dates_match_jax(tmp_path):
    for text in ("2020-02-03", "1999-12", "20240229", "0001-01-01"):
        a, b = pdates.YMD.parse(text), jdates.YMD.parse(text)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert (a.to_int(), a.is_leap(), a.days_in_month(), a.ordinal(),
                str(a)) == (b.to_int(), b.is_leap(), b.days_in_month(),
                            b.ordinal(), str(b))
        assert dataclasses.astuple(a.next_month()) \
            == dataclasses.astuple(b.next_month())
        assert dataclasses.astuple(a.prev_month()) \
            == dataclasses.astuple(b.prev_month())
    with pytest.raises(ValueError):
        pdates.YMD.parse("June")
    s, e = pdates.YMD(2019, 11), pdates.YMD(2020, 3)
    js, je = jdates.YMD(2019, 11), jdates.YMD(2020, 3)
    as_t = lambda pairs: [tuple(map(dataclasses.astuple, p)) for p in pairs]
    assert as_t(pdates.make_forward_month_pairs(s, e)) \
        == as_t(jdates.make_forward_month_pairs(js, je))
    assert as_t(pdates.make_backward_month_pairs(e, s)) \
        == as_t(jdates.make_backward_month_pairs(je, js))
    assert pdates.time_gap_seconds(s, e) == jdates.time_gap_seconds(js, je)
    tmpl = "mpas.{year}-{month}-{day}.nc"
    assert pdates.render_name(tmpl, s) == jdates.render_name(tmpl, js)
    src = tmp_path / "t.yaml"
    src.write_text('    - name: data\n      filenames: "x.nc"\n      vars:\n')
    for mod, a, b, out in ((pdates, s, e, "p.yaml"), (jdates, js, je, "j.yaml")):
        mod.generate_pair_yaml(str(src), str(tmp_path / out), a, b, tmpl)
    assert (tmp_path / "p.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    assert "2019-11" in (tmp_path / "p.yaml").read_text()


def _vti_arrays(path):
    text = open(path).read()
    return [np.array(block.split(), dtype=np.float64) for block in re.findall(
        r'format="ascii">\s*(.*?)\s*</DataArray>', text, re.S)]


def test_cli_on_the_cpu_writes_the_remap(tmp_path, capsys):
    """One small CLI run with --device cpu: every output file exists, the
    VTP holds n_lines x (n_records + 1) points, and remap.vti holds the
    images run_remapping gives on the same mesh and fields."""
    from mops_tpu_torch import cli
    out = tmp_path / "out"
    assert cli.main(["--synthetic", "600", "--layers", "6", "--remap-size",
                     "48x24", "--samples", "4x4", "--duration", "3600",
                     "--dt", "600", "--record", "1200", "--device", "cpu",
                     "--out", str(out)]) == 0
    assert "written" in capsys.readouterr().out
    for name in ("remap_east.png", "remap_north.png", "remap_speed.png",
                 "remap.vti", "streamline.vtp", "streamline.txt"):
        assert (out / name).exists(), name
    head = (out / "streamline.vtp").read_text()[:400]
    n_pts, n_lines = map(int, re.search(
        r'NumberOfPoints="(\d+)" NumberOfLines="(\d+)"', head).groups())
    assert n_lines == 9 and n_pts == n_lines * (3600 // 1200 + 1)

    mesh = mtt.synth.build_voronoi_mesh(600, jitter=0.05)
    sol = mtt.preprocess(mesh, mtt.synth.solid_body_fields(mesh, n_layers=6),
                         device="cpu")
    imgs = mtt.remap.run_remapping(mtt.Field(mesh, sol, device="cpu"),
                                   mtt.VisualizationSettings(
                                       image_width=48, image_height=24,
                                       fixed_depth=10.0))
    pimage.save_vti(str(tmp_path / "want.vti"), imgs, ["velocity", "attrs"])
    assert (out / "remap.vti").read_bytes() \
        == (tmp_path / "want.vti").read_bytes()
    for got, want in zip(_vti_arrays(out / "remap.vti"), imgs):
        np.testing.assert_allclose(got, want.ravel(), rtol=1e-8,
                                   equal_nan=True)


def test_port_imports_without_jax_yaml_matplotlib_pil_h5py():
    """The card's copy has none of these packages: every module of the
    port, the CLI, the API and chip_smoke.py import with them blocked."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'yaml', 'matplotlib', "
        "'PIL', 'h5py', 'mops_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import mops_tpu_torch.cli, mops_tpu_torch.api, mops_tpu_torch.remap\n"
        "import mops_tpu_torch.pymops, mops_tpu_torch.io.cache\n"
        "import mops_tpu_torch.io.imagebuffer, mops_tpu_torch.utils.dates\n"
        "import chip_smoke\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
