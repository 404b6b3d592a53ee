"""The port's task agent (mops_tpu_torch.agent) against mops_tpu.agent.

Routing and config extraction are the same stdlib code, so they must be
equal on the same requests (apart from the default device, "cuda" in the
port); the generated stream YAML must parse the same with both packages'
StreamConfig; a rendered job imports only mops_tpu_torch, and a
streamline job run end to end on the CPU (a fresh interpreter, as
run_agent runs it) must write the VTP a direct MOPSApp run writes, byte
for byte.
"""

import json
import os
import re

import pytest
import torch

import chip_smoke
import mops_tpu_torch as mtt
from mops_tpu import agent as jagent
from mops_tpu.io import StreamConfig as JStreamConfig
from mops_tpu_torch import agent
from mops_tpu_torch.agent import llm_client
from mops_tpu_torch.io import MPASOReader, StreamConfig
from mops_tpu_torch.io import image as imgio

torch.set_num_threads(1)

REQUESTS = [
    "remap the velocity to a global image",
    "draw streamlines for one snapshot",
    "particle trajectories across months",
    "do something with the ocean",
    "regrid temperature at depth of 30 m, 720x360",
    "7-day streamline at depth of 25 m, 16x16 seeds, dt=2 min, euler, "
    "in the gulf of mexico",
    "backward pathline in the north atlantic with lat range (10, 20) and "
    "lon [-40, -30], dt = 30 min",
    "global steady flow, 3 day run",
    "drift of particles",
]


@pytest.mark.parametrize("request_text", REQUESTS)
def test_routing_and_config_equal_jax(request_text):
    got, ref = agent.route_request(request_text), \
        jagent.route_request(request_text)
    assert (got.task, got.confidence, got.reason) == \
        (ref.task, ref.confidence, ref.reason)
    for task in agent.agent.SUPPORTED_TASKS:
        cfg = agent.extract_config(task, request_text)
        want = jagent.extract_config(task, request_text)
        assert cfg.pop("device") == "cuda" and want.pop("device") == "tpu"
        assert cfg == want


def test_llm_routing_and_fallback():
    llm = lambda system, user: \
        'sure: {"task": "streamline", "confidence": 0.9, "reason": "x"}'
    r = agent.route_request("whatever", llm=llm)
    assert (r.task, r.confidence, r.reason) == ("streamline", 0.9, "x")

    def broken(system, user):
        raise RuntimeError("no network")
    assert agent.route_request("remap this", llm=broken).task == "remapping"
    bad = lambda system, user: '{"task": "teleport"}'
    assert agent.route_request("streamline", llm=bad).task == "streamline"


def test_llm_client_endpoints_equal_jax(monkeypatch):
    for var in ("FOUNDRY_BASE_URL", "AZURE_INFERENCE_ENDPOINT",
                "AZURE_OPENAI_ENDPOINT", "OPENAI_BASE_URL", "FOUNDRY_API_KEY",
                "AZURE_INFERENCE_API_KEY", "AZURE_OPENAI_API_KEY",
                "OPENAI_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    jl = jagent.llm_client
    assert llm_client.resolve_provider() == jl.resolve_provider()
    monkeypatch.setenv("AZURE_OPENAI_ENDPOINT", "https://x.azure.com")
    monkeypatch.setenv("AZURE_OPENAI_API_KEY", "k")
    assert llm_client.resolve_provider() == jl.resolve_provider() == \
        ("foundry", "https://x.azure.com", "k")
    for args in (("https://x.azure.com", "foundry", "2024-02-01", "gpt4"),
                 ("https://api.openai.com/v1", "openai"),
                 ("https://h/v1/chat/completions", "openai")):
        assert llm_client.chat_endpoint(*args) == jl.chat_endpoint(*args)


def test_llm_client_against_local_server():
    """An offline chat API on localhost; the client retries a first 503."""
    import http.server
    import threading

    calls = {"n": 0}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            calls["n"] += 1
            if calls["n"] == 1:
                self.send_response(503)
                self.end_headers()
                self.wfile.write(b"busy")
                return
            req = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            assert req["messages"][0]["role"] == "system"
            out = {"choices": [{"message": {"content":
                   '{"task": "pathline", "reason": "mock"}'}}]}
            self.send_response(200)
            self.end_headers()
            self.wfile.write(json.dumps(out).encode())

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        llm = agent.make_llm(model="m", provider="openai", api_key="k",
                             base_url=f"http://127.0.0.1:"
                                      f"{srv.server_address[1]}/v1")
        r = agent.route_request("anything", llm=llm)
        assert r.task == "pathline" and calls["n"] == 2
    finally:
        srv.shutdown()


@pytest.mark.parametrize("request_text,task", [
    ("remap at depth of 20 m, 360x180", "remapping"),
    ("a streamline at depth of 5 m", "streamline"),
    ("pathline over months", "pathline")])
def test_rendered_jobs_import_only_the_port(tmp_path, request_text, task):
    got, path, cfg = agent.generate_job(request_text,
                                        output_dir=str(tmp_path))
    assert got == task and cfg["device"] == "cuda"
    src = open(path).read()
    compile(src, path, "exec")
    imports = re.findall(r"^(?:import|from) (\S+)", src, re.M)
    assert {m.split(".")[0] for m in imports} == {"json", "os",
                                                  "mops_tpu_torch"}
    assert "jax" not in src and "mops_tpu " not in src
    sidecar, = [f for f in os.listdir(tmp_path) if f.startswith("config_")]
    assert json.load(open(tmp_path / sidecar)) == cfg
    if task == "pathline":      # the grid comes before the snapshots
        assert src.index("app.add_grid(mesh)") < src.index("add_solution")


@pytest.fixture(scope="module")
def data_folder(tmp_path_factory):
    """A small NetCDF-3 data folder: a 500-cell L6 mesh and two snapshots
    (chip_smoke.write_nc3_dataset, which phase 7 writes at its size)."""
    folder = tmp_path_factory.mktemp("ncdata")
    mesh = mtt.synth.build_voronoi_mesh(500, n_layers=6)
    raws = [mtt.synth.solid_body_fields(mesh, n_layers=6, w_scale=1e-4,
                                        omega=w) for w in (1e-5, 1.2e-5)]
    chip_smoke.write_nc3_dataset(str(folder), mesh, raws)
    return folder


def test_generate_stream_yaml_parses_like_jax(data_folder, tmp_path):
    out = agent.generate_stream_yaml(str(data_folder),
                                     str(tmp_path / "auto.yaml"))
    ref = jagent.generate_stream_yaml(str(data_folder),
                                      str(tmp_path / "ref.yaml"))
    assert open(out).read() == open(ref).read()
    got, want = StreamConfig.parse(out), JStreamConfig.parse(ref)
    for name in ("mesh", "data"):
        a, b = got.substream(name), want.substream(name)
        assert a.filenames == b.filenames and a.static == b.static
        assert a.possible_names == b.possible_names
    assert [os.path.basename(f) for f in got.substream("data").filenames] \
        == ["data_0000.nc", "data_0001.nc"]
    reader = MPASOReader(got)
    assert reader.read_mesh().n_cells == 500


def test_streamline_job_end_to_end_equals_mopsapp(data_folder, tmp_path):
    ypath = agent.generate_stream_yaml(str(data_folder),
                                       str(tmp_path / "auto.yaml"))
    out = tmp_path / "out"
    overrides = {"device": "cpu", "yaml_path": ypath,
                 "output_subdir": str(out), "grid": [3, 4],
                 "delta_minutes": 60, "record_every_minutes": 120}
    rc = agent.run_agent("1-day streamline at depth of 15 m in the north "
                         "atlantic", output_dir=str(tmp_path / "jobs"),
                         dry_run=False, overrides=overrides)
    assert rc == 0
    cfg = json.load(open(next((tmp_path / "jobs").glob("config_*.json"))))
    assert cfg["duration_days"] == 1 and cfg["fixed_depth"] == 15.0

    app = mtt.MOPSApp()
    app.init("cpu")
    app.begin()
    reader = MPASOReader(StreamConfig.parse(ypath))
    raw = reader.read_solution(0)
    raw.pop("_timestamp", None)
    app.add_grid(reader.read_mesh())
    app.add_solution(1, raw)
    app.end()
    app.active_attribute(1)
    seeds = app.generate_sample_points(mtt.SamplingSettings(
        sample_range=(3, 4), lat_range=(20.0, 50.0),
        lon_range=(-80.0, -50.0), depth=15.0))
    lines = app.run_streamline(mtt.TrajectorySettings(
        delta_t=3600, record_t=7200, simulation_duration=mtt.ONE_DAY,
        depth=15.0, fail_mode=mtt.FailMode.ZERO), seeds)
    imgio.save_trajectories_vtp(str(tmp_path / "direct.vtp"), lines)
    got = (out / "streamline.vtp").read_bytes()
    assert got == (tmp_path / "direct.vtp").read_bytes()
    head = got[:400].decode()
    n_pts, n_lines = map(int, re.search(
        r'NumberOfPoints="(\d+)" NumberOfLines="(\d+)"', head).groups())
    assert n_lines == len(lines) > 0 and n_pts == n_lines * (12 + 1)
