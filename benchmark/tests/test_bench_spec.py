"""BENCHMARK.json against the benchmark's contract: names, units, files
found by name, the metrics each cell reports, the time a check takes."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert all(TEXT.match(w) for w in SPEC["command"])
    assert len(SPEC["command"]) <= 32
    assert (ROOT / SPEC["command"][1]).is_file()


def names():
    out = [c["name"] for c in SPEC["configs"]]
    out += [w[k] for w in SPEC["workloads"] for k in ("name", "config",
                                                      "traffic")]
    out += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    out += [k for c in SPEC["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", names())
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert TEXT.match(metric["layer"])
        assert metric["moves"] in E2E
        # a reader of its own, found by the metric's name
        assert (ROOT / "benchmark" / "metrics"
                / f"{metric['name']}.py").is_file()
        for w in metric["workloads"]:
            e2e = E2E[metric["moves"]]
            assert "workloads" not in e2e or w in e2e["workloads"]


def test_unique_names():
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in SPEC[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(ms) == len(set(ms))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert TEXT.match(config["source"]) and TEXT.match(config["why"])
    assert config["source"].startswith("https://")
    assert config["file"].startswith("benchmark/configs/")
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert body["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert TEXT.match(cell["why"])
    bench = ROOT / "benchmark"
    assert (bench / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = json.loads((bench / "limits" / f"{cell['name']}.json")
                        .read_text())["limits"]
    assert limits
    e2e = [m for m in SPEC["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in SPEC["per_layer"])


def test_check_time_fits():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compile a cell
    and 1,200 s spare fit in 43,200 s."""
    t = SPEC["run_seconds"]
    assert isinstance(t, int) and 1 <= t <= 51
    assert (2 + 14 * 24) * (t + 60) + 24 * 180 + 1200 <= 43200


def test_setup_bound():
    assert E2E["setup_s"]["bound"] <= 0.25
