"""The harness's run with the look for a card skipped (the program on the
CPU, small traffic): sound, it comes out correct; with the timed path
broken underneath, not correct.  And the control (the reference with its
neighbour search cut to one pigeonhole segment) is judged not correct."""

import json

import numpy as np
import pytest

import control
from pbench import harness

SMALL = {"se100_default.wgs_qc": {"reads": 3000, "duplicate_share": 0.4,
                                  "substitution_rate": 0.02},
         "pe150_umi8_m2.umi_qc": {"reads": 3000, "molecules": 2500,
                                  "substitution_rate": 0.02}}


def _run(capsys, workload, trace=0):
    rc = harness.main(["--workload", workload, "--seed", "3000000019",
                       "--seconds", "0.3", "--trace", str(trace)],
                      on_card=False, build=False,
                      traffic_override=SMALL[workload])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(bench_env, capsys, workload):
    line = _run(capsys, workload)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"reads_per_s", "device_peak_mib",
                                    "host_peak_rss_mib", "setup_s"}
    assert list(line)[-1] == "checks"
    assert all(c["value"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_run_takes_and_reports_the_stated_route(bench_env, capsys, workload):
    rc = harness.main(["--workload", workload, "--seed", "17",
                       "--seconds", "0.1", "--trace", "0"],
                      on_card=False, build=False,
                      traffic_override=SMALL[workload])
    err = capsys.readouterr().err
    assert rc == 0
    route = next(ln for ln in err.splitlines() if ln.startswith("# route:"))
    _, _, _, traffic = harness.cell(workload)
    want = traffic["environment"]["HUMID_TPU_TORCH_STRATEGY"]
    assert f'"strategy": "{want}"' in route and "as stated" in route
    assert "NOT as stated" not in route
    assert "the calibration is off; the route is stated" in err


def test_stated_route_compares_what_is_stated():
    env = {"HUMID_TPU_TORCH_STRATEGY": "dense",
           "HUMID_TPU_TORCH_UNIQUE": "device"}
    assert harness.stated_route(env, {"strategy": "dense",
                                      "unique": "device", "metric": "h"})
    assert not harness.stated_route(env, {"strategy": "runs",
                                          "unique": "device"})
    assert not harness.stated_route(env, {"strategy": "dense",
                                          "unique": "host"})
    assert harness.stated_route({}, {"strategy": "runs"})


def test_router_choices_run_in_a_child_where_calibration_is_on(
        bench_env, monkeypatch, tmp_path):
    _, _, config, traffic = harness.cell("se100_default.wgs_qc")
    traffic = {**traffic, **SMALL["se100_default.wgs_qc"]}
    meta = harness.Inputs(config, traffic, 5, "cpu_child").wait()
    harness.set_cache_env()
    monkeypatch.setenv("HUMID_TPU_TORCH_CALIBRATION", "off")
    assert harness.route_in_child(meta["files"], config["run"],
                                  str(tmp_path), "cpu") is None
    monkeypatch.delenv("HUMID_TPU_TORCH_CALIBRATION")
    monkeypatch.delenv("HUMID_TPU_TORCH_STRATEGY", raising=False)
    child = harness.route_in_child(meta["files"], config["run"],
                                   str(tmp_path), "cpu")
    # On the CPU the router picks the host engine and measures nothing.
    assert child["route"]["strategy"] == "runs"
    assert child["calibration_changed"] is False
    assert child["seconds"] > 0


def test_traced_run_reports_per_layer_metrics(bench_env, capsys):
    line = _run(capsys, "se100_default.wgs_qc", trace=1)
    assert line["correct"] is True
    assert {"pass1_ms", "neighbours_ms", "cluster_ms",
            "stats_ms"} <= set(line["metrics"])
    assert "k1_roofline" not in line["metrics"]  # no card, no K1


def _drop_last_pair(orig):
    def fn(*a, **kw):
        pa, pb = orig(*a, **kw)
        return pa[:-1], pb[:-1]
    return fn


def _half_the_reads(orig):
    def fn(*a, **kw):
        packed, filtered = orig(*a, **kw)
        n = len(filtered) // 2
        return packed[:n], filtered[:n]
    return fn


def _one_count_off(orig):
    def fn(*a, **kw):
        out = list(orig(*a, **kw))
        out[1] = np.array(out[1], copy=True)
        out[1][0] += 1
        return tuple(out)
    return fn


def _other_representative(orig):
    def fn(*a, **kw):
        cl = orig(*a, **kw)
        big = int(np.argmax(cl.size))
        u = len(cl.labels)
        cl.max_leaf[big] = (cl.max_leaf[big] + 1) % u
        return cl
    return fn


FAULTS = {
    # An answer altered where it is produced: a pair of the neighbour
    # search, a count of unique counting, a cluster's representative.
    "dropped_pair": ("find_neighbor_pairs", _drop_last_pair),
    "count_altered": ("unique_words", _one_count_off),
    "representative_altered": ("cluster_dispatch", _other_representative),
    # Half of the batch left out: pass 1 hands on half the reads.
    "half_the_reads": ("_pass1", _half_the_reads),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_broken_timed_path_is_not_correct(bench_env, capsys, monkeypatch,
                                          workload, fault):
    from humid_tpu_torch import pipeline

    name, wrap = FAULTS[fault]
    monkeypatch.setattr(pipeline, name, wrap(getattr(pipeline, name)))
    line = _run(capsys, workload)
    assert line["correct"] is False
    # Statistics files are compared for every iteration, whole results
    # for the iterations drawn from the seed.
    assert 1 <= line["failed"] <= line["attempted"]


def test_module_loaded_after_the_window_stops_the_result(
        bench_env, capsys, monkeypatch):
    """The look for forbidden modules comes last, after the profiled
    slice, the readers and the reference have run."""
    import sys
    import types

    from reference import humid_np

    orig = humid_np.humid

    def loads_jax(*a, **kw):
        sys.modules["jax"] = types.ModuleType("jax")
        return orig(*a, **kw)

    monkeypatch.setattr(humid_np, "humid", loads_jax)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        rc = harness.main(["--workload", "se100_default.wgs_qc", "--seed",
                           "9", "--seconds", "0.1", "--trace", "1"],
                          on_card=False, build=False,
                          traffic_override=SMALL["se100_default.wgs_qc"])
    finally:
        sys.modules.pop("jax", None)
    captured = capsys.readouterr()
    assert rc == 3
    assert "jax" in captured.err and captured.out == ""


def test_iteration_that_raises_is_failed(bench_env, capsys, monkeypatch):
    from humid_tpu_torch import pipeline

    orig, calls = pipeline.find_neighbor_pairs, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 2:  # the window's first iteration (1: warm-up)
            raise RuntimeError("injected")
        return orig(*a, **kw)

    monkeypatch.setattr(pipeline, "find_neighbor_pairs", flaky)
    line = _run(capsys, "se100_default.wgs_qc")
    assert line["correct"] is False
    assert line["failed"] == 1
    assert line["checks"]["iterations_failed"]["value"] == 1


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(bench_env, workload):
    _, _, config, traffic = harness.cell(workload)
    traffic = {**traffic, **SMALL[workload]}
    meta = harness.Inputs(config, traffic, 2147483659, workload).wait()
    checks = control.readings(meta["files"], config["run"])
    assert checks["neighbour_degrees_differing"]["value"] > 0
    assert checks["stats_files_differing"]["value"] > 0
    sound = control.readings(meta["files"], config["run"],
                             search_segments=None)
    assert all(c["value"] == 0 for c in sound.values())
