"""The port's web front end (mops_tpu_torch.frontend) on the CPU: the routes
of mops_tpu.frontend (tests/test_frontend.py), the traversal guard, a
dry-run task, and /api/status reporting the torch device.  A task that
runs its job asks for the card by default, so without one it fails
instead of running on the CPU."""

import json
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mops_tpu_torch.frontend import serve

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    out = tmp_path_factory.mktemp("outputs")
    with open(out / "pathline.bin", "wb") as f:
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<i", 2))
        f.write(np.array([[10.0, 20.0], [11.0, 21.0]], "<f8").tobytes())
        f.write(np.array([[0.1, 0.2, 0.3], [0.1, 0.2, 0.3]], "<f8").tobytes())
    (out / "notes.txt").write_text("not listed")
    srv = serve(port=0, output_dir=str(out), browse_root=str(out),
                background=True)
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_status_names_the_torch_device(server):
    code, body = _get(server + "/api/status")
    data = json.loads(body)
    assert code == 200 and data["status"] == "ok"
    assert (data["device"], data["n_devices"]) == ("cpu", 1)


def test_status_on_a_card(server, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Card X")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    data = json.loads(_get(server + "/api/status")[1])
    assert (data["device"], data["n_devices"]) == ("cuda:Card X", 2)


def test_viewer_page(server):
    code, body = _get(server + "/")
    assert code == 200 and b"mops_tpu_torch pathline viewer" in body


def test_outputs_serving_and_traversal_guard(server):
    code, body = _get(server + "/outputs/pathline.bin")
    assert code == 200 and struct.unpack("<i", body[:4])[0] == 1
    for bad in ("/outputs/../../../etc/passwd", "/outputs/%2e%2e/secret",
                "/outputs/missing.png"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server + bad)
        assert e.value.code in (403, 404)


def test_browse(server):
    data = json.loads(_get(server + "/api/browse")[1])
    names = [f["name"] for f in data["files"]]
    assert names == ["pathline.bin"]


@pytest.mark.parametrize("route", ["/api/remapping", "/api/task"])
def test_task_api_dry_run(server, route):
    data = _post(server + route, {"request": "remap at depth of 15 m",
                                  "dry_run": True})
    assert data["success"] and data["task"] == "remapping"
    assert data["config"]["fixed_depth"] == 15.0
    assert data["config"]["device"] == "cuda"
    src = open(data["script"]).read()
    assert "import mops_tpu_torch as mtt" in src


def test_task_api_rejects_empty_and_bad_json(server):
    for body in (b"{}", b"{not json"):
        req = urllib.request.Request(
            server + "/api/task", data=body,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400


def test_task_run_without_a_card_fails(server, tmp_path, monkeypatch):
    """The job asks for "cuda" (the default): without a card its MOPSApp
    raises, and the task reports failure rather than a CPU run.  The job
    writes under the server's working directory, here ``tmp_path``."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "empty").mkdir()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/api/task", {"request": "streamline",
                                     "data_folder": str(tmp_path / "empty")})
    assert e.value.code == 400
    assert "yaml generation" in json.loads(e.value.read())["error"]
    data = _post(server + "/api/task", {"request": "a 1-day streamline",
                                        "dry_run": False}, timeout=120)
    assert data["task"] == "streamline" and not data["success"]
    assert (tmp_path / "agent_outputs" / "streamline").is_dir()
