"""The readers of the program's span tree (``phaselog.py``): each on a
fixed ``Context`` gives the expected value, or None where its spans are
missing (a program without the tree); and a traced CPU run reports them
all, each inside the phase it divides."""

import json

import pytest

from pbench import harness

NEIGH = "Calculating neighbours using Hamming distance"
STATS = "Calculating count and neighbour stats"

#: Two iterations' timings (seconds) of a program with the span tree.
SPANNED = [
    {"run": 0.200, "set-up": 0.002, "Determing nucleotides to take": 0.001,
     "Reading data": 0.060, "Reading data/wait reader": 0.020,
     "Reading data/wait pack": 0.010, "Reading data/concat": 0.001,
     "unique counting": 0.004, NEIGH: 0.070, f"{NEIGH}/inputs": 0.003,
     f"{NEIGH}/upload": 0.002, f"{NEIGH}/wait K1": 0.050,
     f"{NEIGH}/pairs": 0.004, f"{NEIGH}/csr": 0.006,
     "Calculating directional clusters": 0.030, "outputs": 0.005,
     STATS: 0.020},
    {"run": 0.300, "set-up": 0.004, "Determing nucleotides to take": 0.001,
     "Reading data": 0.100, "Reading data/wait reader": 0.040,
     "Reading data/wait pack": 0.030, "Reading data/concat": 0.001,
     "unique counting": 0.006, NEIGH: 0.090, f"{NEIGH}/inputs": 0.003,
     f"{NEIGH}/upload": 0.002, f"{NEIGH}/wait K1": 0.060,
     f"{NEIGH}/pairs": 0.006, f"{NEIGH}/csr": 0.008,
     "Calculating directional clusters": 0.040, "outputs": 0.007,
     STATS: 0.030},
]
#: The same phases without the tree (the parent program).
PHASES_ONLY = [{k: v for k, v in t.items()
                if "/" not in k and k not in ("run", "set-up", "outputs")}
               for t in SPANNED]

EXPECTED = {
    "stats_phase_ms": 25.0,
    "pass1_reader_wait_ms": 30.0,
    "pass1_pack_wait_ms": 20.0,
    # (70 - 50 - 4 + 90 - 60 - 6) / 2
    "neighbours_host_ms": 20.0,
    # (200 - 192) and (300 - 278)
    "unphased_ms": 15.0,
}


def _ctx(timings):
    return harness.Context(timings, {}, unique=0, pairs=0, lanes=2)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_fixed_context(name):
    assert harness.read_metric(name, _ctx(SPANNED)) == \
        pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_the_span_tree_is_none(name):
    assert harness.read_metric(name, _ctx(PHASES_ONLY)) is None
    assert harness.read_metric(name, _ctx([])) is None


def test_overlapped_unique_counting_is_not_a_child_of_run():
    t = dict(SPANNED[0])
    t["unique counting (overlapped)"] = t.pop("unique counting")
    got = harness.read_metric("unphased_ms", _ctx([t]))
    assert got == pytest.approx(8.0 + 4.0)


def test_traced_run_reports_the_span_metrics(bench_env, capsys):
    rc = harness.main(["--workload", "se100_default.wgs_qc",
                       "--seed", "3000000019", "--seconds", "0.3",
                       "--trace", "1"], on_card=False, build=False,
                      traffic_override={"reads": 3000,
                                        "duplicate_share": 0.4,
                                        "substitution_rate": 0.02})
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"] is True
    assert set(EXPECTED) <= set(m)
    assert m["pass1_reader_wait_ms"] + m["pass1_pack_wait_ms"] \
        <= m["pass1_ms"]
    assert 0 < m["neighbours_host_ms"] < m["neighbours_ms"]
    assert m["unphased_ms"] >= 0
    assert m["stats_phase_ms"] > 0
