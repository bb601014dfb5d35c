"""Everything ``BENCHMARK.json`` names is found by name, and the file keeps
to the benchmark's format: its keys, names and limits."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("cfg", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(cfg):
    path = os.path.join(ROOT, cfg["file"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = json.load(open(path))
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert any(w["config"] == cfg["name"] for w in BENCHMARK["workloads"])


@pytest.mark.parametrize("wl", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_workload_files_found_by_name(wl):
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
    assert wl["chips"] in (1, 4) and len(wl["why"]) <= 200
    assert os.path.exists(os.path.join(BENCH, "configs",
                                       f"{wl['config']}.json"))
    traffic = json.load(open(os.path.join(BENCH, "traffic",
                                          f"{wl['traffic']}.json")))
    from pbench import generate

    mod = generate.generator(traffic)
    assert hasattr(mod, "molecules") or hasattr(mod, "generate")


@pytest.mark.parametrize("metric", BENCHMARK["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(metric):
    from pbench import harness

    path = os.path.join(BENCH, "metrics", f"{metric['name']}.py")
    assert os.path.exists(path)
    ctx = harness.Context([], {}, unique=0, pairs=0, lanes=2)
    assert harness.read_metric(metric["name"], ctx) is None
    assert metric["moves"] in {m["name"] for m in BENCHMARK["end_to_end"]}


def test_names_units_and_bounds():
    metrics = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
    names = [m["name"] for m in metrics] + [
        w["name"] for w in BENCHMARK["workloads"]] + [
        c["name"] for c in BENCHMARK["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCHMARK["end_to_end"]}
    layers = {m["layer"] for m in BENCHMARK["per_layer"]}
    assert all("\n" not in layer for layer in layers)
