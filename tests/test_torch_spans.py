"""The span tree of one ``run`` of the port (``phaselog.PhaseLog.span``)
on the CPU: the root span ``run`` and its children for the route taken,
their sums, a span opened per batch summed, the statistics phase around
its writer, each span nested in its phase's range of a profiler trace,
and a ``-l`` log that spans leave as it was.

Inputs are made with numpy from fixed seeds.
"""

import json
import os
import re
import sys
import time
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from humid_tpu_torch import phaselog
from humid_tpu_torch import pipeline as P
from humid_tpu_torch import run

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402

NEIGH = "Calculating neighbours using Hamming distance"
LEV = "Calculating neighbours using Levenshtein distance"
STATS = "Calculating count and neighbour stats"
PHASES = {"Determing nucleotides to take", "Reading data", NEIGH,
          "Calculating directional clusters", "Writing filtered results",
          "Writing annotated results", STATS}
COMMON = PHASES | {"run", "set-up", "outputs", "Reading data/wait reader",
                   "Reading data/wait pack", "Reading data/concat",
                   f"{NEIGH}/csr"}
DENSE = {f"{NEIGH}/{s}" for s in ("inputs", "upload", "wait K1", "pairs")}
#: The shifted edit search's spans (-e, strategy "runs").
SHIFTED = {f"{LEV}/{s}" for s in ("joins", "dedupe", "verify",
                                   "wait verify")}
#: Route -> (its environment, the names beyond COMMON that it gives).
ROUTES = {
    "dense": ({"HUMID_TPU_TORCH_STRATEGY": "dense"},
              DENSE | {"unique counting"}),
    "dense_device_unique": ({"HUMID_TPU_TORCH_STRATEGY": "dense",
                             "HUMID_TPU_TORCH_UNIQUE": "device"},
                            DENSE | {"unique counting"}),
    "runs": ({"HUMID_TPU_TORCH_STRATEGY": "runs"}, {"unique counting"}),
    "fused": ({"HUMID_TPU_TORCH_FUSED": "1"}, {"unique counting (fused)"}),
    "edit": ({"HUMID_TPU_TORCH_STRATEGY": "runs"},
             SHIFTED | {"unique counting"}),
}
#: Route -> the flags ``run`` takes on it (-e -m 2 on the edit route).
FLAGS = {"edit": {"edit": True, "distance": 2}}


def _common(route):
    """COMMON under the route's neighbour phase."""
    phase = LEV if FLAGS.get(route, {}).get("edit") else NEIGH
    return phase, {k.replace(NEIGH, phase) for k in COMMON}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs, shared cores: one thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_and_clean_env(monkeypatch):
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE", "cpu")
    for var in (P.PROFILE_ENV_VAR, "HUMID_TPU_TORCH_FUSED",
                "HUMID_TPU_TORCH_STRATEGY", "HUMID_TPU_TORCH_UNIQUE",
                "HUMID_TPU_TORCH_IMPL", "HUMID_TPU_TORCH_SPAN_CACHE",
                P.OVERLAP_ENV_VAR):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    gen_dataset(np.random.default_rng(71), str(d), n_reads=3000, n_files=2,
                umi_style="underscore")
    return [str(d / f"file{i}.fastq") for i in range(2)]


def _run(files, out, **kw):
    kw = {"log_name": os.devnull, "run_stats": True,
          "write_annotated": True, **kw}
    return run(files, dir_name=str(out), **kw)


def _children_of_run(timings):
    """The direct children of ``run`` (the tree in :mod:`phaselog`)."""
    return {k: v for k, v in timings.items()
            if "/" not in k and k not in ("run",
                                          "unique counting (overlapped)")}


def test_span_timings_sum_repeats_and_close_on_raise(tmp_path):
    log = phaselog.PhaseLog(str(tmp_path / "x.log"))
    t = log.start("Reading data")
    for _ in range(3):
        with log.span("Reading data/wait pack"):
            time.sleep(0.002)
    log.end(t)
    with pytest.raises(KeyError):
        with log.span("boom"):
            raise KeyError("x")
    log.close()
    assert [m for m, _ in log.timings] == ["Reading data"]
    waits = [dt for m, dt in log.span_timings
             if m == "Reading data/wait pack"]
    assert len(waits) == 3 and min(waits) >= 0.002
    totals = log.totals()
    assert totals["Reading data/wait pack"] == pytest.approx(sum(waits))
    assert totals["Reading data"] >= sum(waits)
    assert "boom" in totals
    assert (tmp_path / "x.log").read_text() == \
        "Reading data... done. (0m0s)\n"


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_run_gives_its_span_tree(route, files, tmp_path, monkeypatch):
    env, extra = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    neigh, common = _common(route)
    res = _run(files, tmp_path / "o", **FLAGS.get(route, {}))
    tim = res.extra["timings"]
    assert set(tim) == common | extra
    # The children of ``run`` tile it: they sum to ``run`` within 2%.
    kids = sum(_children_of_run(tim).values())
    assert kids <= tim["run"]
    assert tim["run"] - kids <= 0.02 * tim["run"], (tim["run"], kids)
    # A phase's spans lie inside it.
    for phase in ("Reading data", neigh):
        below = sum(v for k, v in tim.items()
                    if k.startswith(phase + "/"))
        assert 0 < below <= tim[phase]
    # Each step of the neighbour search took time.
    assert all(tim[k] > 0 for k in tim if k.startswith(neigh + "/")
               and (k in extra or k.endswith("/csr")))


def test_span_opened_per_batch_is_summed(files, tmp_path, monkeypatch):
    logs = []

    class Recording(phaselog.PhaseLog):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            logs.append(self)

    monkeypatch.setattr(P, "PhaseLog", Recording)
    res = _run(files, tmp_path / "o", batch_records=256)
    (log,) = logs
    for name in ("Reading data/wait reader", "Reading data/wait pack"):
        each = [dt for m, dt in log.span_timings if m == name]
        assert len(each) > 5, name
        assert res.extra["timings"][name] == pytest.approx(sum(each))


def test_statistics_phase_holds_the_writer(files, tmp_path, monkeypatch):
    real = P.write_statistics

    def slow(**kw):
        time.sleep(0.05)
        return real(**kw)

    monkeypatch.setattr(P, "write_statistics", slow)
    res = _run(files, tmp_path / "o")
    assert res.extra["timings"][STATS] >= 0.05
    assert (tmp_path / "o" / "stats.dat").exists()


def _ranges(profile_dir):
    (name,) = os.listdir(profile_dir)
    with open(os.path.join(profile_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def test_profiler_trace_nests_each_span_in_its_phase(files, tmp_path,
                                                     monkeypatch):
    """Every span but the root is a range of the trace; a phase's spans
    lie inside its range, and the root's children follow each other
    without overlapping."""
    monkeypatch.setenv("HUMID_TPU_TORCH_STRATEGY", "dense")
    res = _run(files, tmp_path / "o", profile_dir=str(tmp_path / "prof"))
    ranges = _ranges(tmp_path / "prof")
    names = {n for n, _, _ in ranges}
    assert set(res.extra["timings"]) - names == {"run"}

    def inside(s, e, parent):
        return any(n == parent and ps <= s and e <= pe
                   for n, ps, pe in ranges)

    for name, s, e in ranges:
        if "/" in name:
            assert inside(s, e, name.rsplit("/", 1)[0]), name
    top = sorted((s, e) for n, s, e in ranges
                 if n in _children_of_run(res.extra["timings"]))
    assert len(top) > len(PHASES)
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(top, top[1:]))


def test_log_bytes_equal_an_unspanned_run(files, tmp_path, monkeypatch):
    def norm(path):
        return re.sub(r"\(\d+m\d+s\)", "(XmYs)", path.read_text())

    _run(files, tmp_path / "a", log_name=str(tmp_path / "spanned.log"))
    monkeypatch.setattr(phaselog.PhaseLog, "span",
                        lambda self, name, **kw: nullcontext())
    res = _run(files, tmp_path / "b", log_name=str(tmp_path / "plain.log"))
    assert set(res.extra["timings"]) == PHASES
    assert norm(tmp_path / "spanned.log") == norm(tmp_path / "plain.log")


def test_edit_search_counts_its_candidates_batches_and_pairs(
        files, tmp_path, monkeypatch):
    """The shifted edit search's counters: the distinct candidates are
    the joins' output less what an earlier join had found, the DP's
    batches are the distinct candidates over the batch, rounded up, and
    the pairs kept are the run's neighbour pairs."""
    from humid_tpu_torch.ops import edit as E

    batch, orig = 256, E.edit_pairs_verify
    monkeypatch.setattr(E, "edit_pairs_verify", lambda *a, **kw: orig(
        *a, **{**kw, "batch": batch}))
    monkeypatch.setenv("HUMID_TPU_TORCH_STRATEGY", "runs")
    res = _run(files, tmp_path / "o", **FLAGS["edit"])
    eng = res.extra["engine"]
    assert eng["metric"] == "edit" and eng["strategy"] == "runs"
    assert eng["candidates"] >= eng["distinct_candidates"] > batch
    assert (eng["candidates"] - eng["first_join_dropped"]
            == eng["distinct_candidates"])
    assert eng["verify_batches"] == -(-eng["distinct_candidates"] // batch)
    assert eng["edit_pairs"] == int(res.degree.sum()) // 2 > 0
    assert eng["join_cap_fallbacks"] == 0


def test_edit_search_gives_the_same_pairs_without_spans(tmp_path):
    """``span=None`` times nothing and changes no pair."""
    from humid_tpu_torch import words as W
    from humid_tpu_torch.ops import find_neighbor_pairs

    rng = np.random.default_rng(20)
    codes = rng.integers(0, 4, (600, 24)).astype(np.uint8)
    # Copies with one base inserted (the last pushed out) or deleted (the
    # last repeated).
    copies = codes[rng.integers(0, 600, 300)].copy()
    for row, pos, ins in zip(copies, rng.integers(0, 23, 300),
                             rng.random(300) < 0.5):
        if ins:
            row[pos + 1:] = row[pos:-1].copy()
            row[pos] = rng.integers(0, 4)
        else:
            row[pos:-1] = row[pos + 1:].copy()
    packed = np.unique(W.pack_words(np.concatenate([codes, copies])),
                       axis=0)
    log = phaselog.PhaseLog(str(tmp_path / "x.log"))
    info = {}
    spanned = find_neighbor_pairs(packed, 2, metric="edit", word_length=24,
                                  strategy="runs", device="cpu", info=info,
                                  span=log.spans_under(LEV))
    log.close()
    plain = find_neighbor_pairs(packed, 2, metric="edit", word_length=24,
                                strategy="runs", device="cpu", span=None)
    for x, y in zip(spanned, plain):
        np.testing.assert_array_equal(x, y)
    assert info["edit_pairs"] == len(plain[0]) > 0
    assert {m for m, _ in log.span_timings} == SHIFTED
