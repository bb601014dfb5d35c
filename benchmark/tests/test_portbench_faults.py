"""The harness's run with the look for a card skipped (the program on the
CPU, small traffic): sound, it comes out correct; with the timed path
broken underneath, not correct.  And the control (the reference with its
neighbour search cut to one pigeonhole segment) is judged not correct.
The same under a test-local ``edit`` configuration (Levenshtein
neighbours, a sample with indels), and a configuration with a flag the
reference does not model is refused before anything runs."""

import json
import os

import numpy as np
import pytest

import control
from conftest import indel_sample
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
            "stats_phase_ms"} <= set(line["metrics"])
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


# ---------------------------------------------------------------------------
# A configuration that states edit (-e): HUMID's defaults at -m 2
# ---------------------------------------------------------------------------

EDIT = "se100_edit.indel_qc"
EDIT_TRAFFIC = {"generator": "duplicate_share", "reads": 3000,
                "duplicate_share": 0.4, "substitution_rate": 0.02,
                "environment": {"HUMID_TPU_TORCH_CALIBRATION": "off"}}
#: Reads added to the sample that copy a read with an indel in the word.
EDIT_INDELS = 400


def _edit_cell(monkeypatch, **run):
    """Point the harness at a test-local configuration (``se100_default``
    with ``run`` changed) and a sample with indel copies."""
    bench, _, config, _ = harness.cell("se100_default.wgs_qc")
    config = {**config, "name": "se100_edit",
              "run": {**config["run"], "distance": 2, "edit": True, **run}}
    entry = {"name": EDIT, "config": "se100_edit", "traffic": "indel_qc",
             "chips": 1, "why": "test-local"}
    bench = {**bench, "workloads": bench["workloads"] + [entry]}
    made = []

    class Inputs:
        def __init__(self, config, traffic, seed, name):
            d = os.path.join(harness.CACHE, "indel", str(seed))
            os.makedirs(d, exist_ok=True)
            self.meta = indel_sample(config, traffic, seed, d, EDIT_INDELS,
                                     config["run"]["word_length"])
            made.append(self.meta)

        def wait(self):
            return {**self.meta, "seconds": 0.0, "cache_hit": False}

        def kill(self):
            pass

    monkeypatch.setattr(harness, "cell", lambda workload: (
        bench, entry, config, dict(EDIT_TRAFFIC)))
    monkeypatch.setattr(harness, "Inputs", Inputs)
    return config, made


def _run_edit(capsys):
    rc = harness.main(["--workload", EDIT, "--seed", "3000000041",
                       "--seconds", "0.3", "--trace", "0"],
                      on_card=False, build=False)
    captured = capsys.readouterr()
    assert rc == 0
    return json.loads(captured.out.strip().splitlines()[-1]), captured.err


def _base_hamming(packed, pa, pb):
    """Bases that differ between the packed words of each pair."""
    z = (packed[pa] ^ packed[pb]).astype(np.uint32)
    z = (z | (z >> np.uint32(1))) & np.uint32(0x55555555)
    return np.bitwise_count(z).sum(axis=1)


def test_edit_configuration_run_is_correct(bench_env, capsys, monkeypatch):
    _edit_cell(monkeypatch)
    line, err = _run_edit(capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["checks"].values())
    route = next(ln for ln in err.splitlines() if ln.startswith("# route:"))
    assert '"metric": "edit"' in route
    ref = next(ln for ln in err.splitlines() if ln.startswith("# reference:"))
    assert " 0 candidates" not in ref


def test_dropped_levenshtein_pair_is_not_correct(bench_env, capsys,
                                                 monkeypatch):
    """One pair within two edits but not within two mismatches, taken out
    of the neighbour search's answer."""
    from humid_tpu_torch import pipeline

    _edit_cell(monkeypatch)
    orig, dropped = pipeline.find_neighbor_pairs, []

    def drop_one(packed, max_dist, **kw):
        pa, pb = orig(packed, max_dist, **kw)
        assert kw["metric"] == "edit"
        far = np.flatnonzero(_base_hamming(packed, pa, pb) > max_dist)
        keep = np.ones(len(pa), bool)
        keep[far[:1]] = False
        dropped.append(len(far) > 0)
        return pa[keep], pb[keep]

    monkeypatch.setattr(pipeline, "find_neighbor_pairs", drop_one)
    line, _ = _run_edit(capsys)
    assert dropped and all(dropped)
    assert line["correct"] is False
    assert line["checks"]["neighbour_degrees_differing"]["value"] > 0


def test_readers_see_the_flags_and_the_reference(bench_env, capsys,
                                                 monkeypatch):
    config, _ = _edit_cell(monkeypatch)
    orig, seen = harness.read_metric, []

    def read_metric(name, ctx):
        seen.append(ctx)
        return orig(name, ctx)

    monkeypatch.setattr(harness, "read_metric", read_metric)
    rc = harness.main(["--workload", EDIT, "--seed", "3000000041",
                       "--seconds", "0.2", "--trace", "1"],
                      on_card=False, build=False)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert seen and all(ctx is seen[0] for ctx in seen)
    ctx = seen[0]
    assert ctx.flags == config["run"] and ctx.flags["edit"] is True
    assert ctx.unique == len(ctx.ref.keys) > 0
    assert ctx.pairs == int(ctx.ref.degree.sum()) // 2
    assert ctx.ref.candidates >= ctx.pairs > 0
    # The Hamming phase's readers find nothing in an edit run.
    assert "neighbours_ms" not in line["metrics"]
    assert harness.read_metric("neighbours_ms", ctx) is None


@pytest.mark.parametrize("run", [{"maximum": True}, {"radius": 3}],
                         ids=["maximum", "unknown"])
def test_unmodelled_flag_is_refused_before_set_up(bench_env, capsys,
                                                  monkeypatch, run):
    from humid_tpu_torch import pipeline

    _, made = _edit_cell(monkeypatch, **run)
    runs = []
    monkeypatch.setattr(pipeline, "run", lambda *a, **kw: runs.append(1))
    key = next(iter(run))
    with pytest.raises(SystemExit, match=key):
        harness.main(["--workload", EDIT, "--seed", "5", "--seconds", "0.1",
                      "--trace", "0"], on_card=False, build=False)
    assert not made and not runs
    assert capsys.readouterr().out == ""


def test_control_is_not_correct_under_edit(bench_env, tmp_path, monkeypatch):
    config, _ = _edit_cell(monkeypatch)
    meta = indel_sample(config, EDIT_TRAFFIC, 2147483659, str(tmp_path),
                        EDIT_INDELS, config["run"]["word_length"])
    checks = control.readings(meta["files"], config["run"])
    assert checks["neighbour_degrees_differing"]["value"] > 0
    assert checks["stats_files_differing"]["value"] > 0
    sound = control.readings(meta["files"], config["run"],
                             search_segments=None)
    assert all(c["value"] == 0 for c in sound.values())
