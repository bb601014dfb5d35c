"""The port's engine router (humid_tpu_torch/_backend.py), mirroring
tests/test_backend.py and the fused gate of tests/test_fused.py with
injected constants: nothing here measures an engine (the measurement is
replaced or refused), and the calibration cache lives in tmp_path.

A CUDA device is named (``torch.device("cuda")``) where the router's
answer for a card is wanted; no card is needed because the constants are
injected.  Where pairs are compared, the engine the router picked runs on
the CPU and must equal the JAX package's host runs engine.
"""

import json
import time

import numpy as np
import pytest
import torch

import humid_tpu_torch._backend as B
from humid_tpu.ops import neighbors as JN
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import unique_words

CUDA = torch.device("cuda")
CPU = torch.device("cpu")
#: The real cache key and measurement (the fixture below replaces them).
CALIB_KEY = B._calib_key
REAL_MEASURE = B._measure_engines


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for var in ("HUMID_TPU_TORCH_DEVICE_ENGINE", "HUMID_TPU_TORCH_FUSED",
                "HUMID_TPU_TORCH_CALIBRATION", "HUMID_TPU_TORCH_STRATEGY",
                "HUMID_TPU_TORCH_UNIQUE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HUMID_TPU_TORCH_CALIB_PATH", str(tmp_path / "c.json"))
    monkeypatch.setattr(B, "_calib_key", lambda device: "key")

    def refuse(device):  # pragma: no cover - must not be called
        raise AssertionError("a real calibration was started")

    monkeypatch.setattr(B, "_measure_engines", refuse)
    B._reset_for_tests()
    yield
    B._reset_for_tests()


def _rand_table(n, wl=24, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, wl)).astype(np.uint8)
    return unique_words(W.pack_words(codes))[0]


#: Probe sizes of the injected rows (reads, unique words).
PROBE_N, PROBE_U = [1 << 19, 1 << 21], [94_000, 375_000]


def _two_point(**per_unit):
    """Rows with no fixed cost and ``per_unit`` ns a unit, in the router's
    two-parameter form."""
    return {k: [0.0, float(v)] for k, v in per_unit.items()}


def _row(**per_unit):
    """A calibration row: ``per_unit`` costs, a dense sweep at 1 ns per
    unique² (slow at every size here) unless given, the probes, now."""
    return {"neighbors_dense_ns": [0.0, 1.0], **_two_point(**per_unit),
            "probe_n": PROBE_N, "probe_u": PROBE_U, "ts": time.time()}


_DEVICE_WINS = _row(
    unique_host_ns=100.0, unique_device_ns=10.0, neighbors_runs_ns=1000.0,
    neighbors_bucketed_ns=100.0, neighbors_runs_device_ns=2000.0,
    cc_host_ns=100.0, cc_device_ns=10.0)
_HOST_WINS = _row(
    unique_host_ns=10.0, unique_device_ns=100.0, neighbors_runs_ns=100.0,
    neighbors_bucketed_ns=1000.0, neighbors_runs_device_ns=2000.0,
    cc_host_ns=10.0, cc_device_ns=100.0)
_RUNS_DEVICE_WINS = dict(_DEVICE_WINS, **_two_point(
    neighbors_runs_device_ns=50.0))
_DENSE_WINS = dict(_DEVICE_WINS, neighbors_dense_ns=[0.0, 1e-3])
_MESH_WINS = dict(_DEVICE_WINS, **_two_point(neighbors_sharded_ns=20.0,
                                             neighbors_runs_device_ns=50.0))

#: Phase 14's wall ms of each engine at the sweep_1M and sweep_10M tables
#: (PERF.md §5: one NVIDIA H100 80GB HBM3 at 700 W).
_PHASE14_MS = {"runs": (40.9, 645.7), "runs_device": (31.2, 265.3),
               "bucketed": (64.8, 717.9), "dense": (6.4, 459.2)}
_SWEEP_U = (178_793, 1_788_324)


def _phase14_row():
    row = {k: [0.0, 1.0] for k in ("unique_host_ns", "unique_device_ns",
                                   "cc_host_ns", "cc_device_ns")}
    for s, ms in _PHASE14_MS.items():
        k = B._NEIGHBOR_ENGINES[s]
        row[k] = B._fit(_SWEEP_U, [t * 1e6 for t in ms], k in B._QUADRATIC)
    return dict(row, probe_n=PROBE_N, probe_u=PROBE_U, spread=0.3,
                ts=time.time())


def _routed_pairs(monkeypatch, uniq):
    """The strategy auto takes for a card, and its pairs run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    strategy = N.choose_engine(len(uniq), 1, 24, device=CUDA)
    pairs = N.find_neighbor_pairs(uniq, 1, word_length=24, strategy=strategy,
                                  device="cpu")
    return strategy, pairs


def test_auto_picks_runs_on_the_cpu_device():
    """On the CPU the router answers the host runs engine and measures
    nothing (the measurement refuses)."""
    uniq = _rand_table(6000)
    assert len(uniq) > 2048
    info = {}
    got = N.find_neighbor_pairs(uniq, 1, word_length=24, device="cpu",
                                info=info)
    assert info["strategy"] == "runs"
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert B.engine_constants(CPU) is None


@pytest.mark.parametrize("calib,want", [
    (_DEVICE_WINS, "bucketed"), (_RUNS_DEVICE_WINS, "runs_device"),
    (_DENSE_WINS, "dense"), (_MESH_WINS, "sharded_bucketed"),
    (_HOST_WINS, "runs")],
    ids=["bucketed", "runs_device", "dense", "mesh", "host"])
def test_auto_follows_the_measured_constants(calib, want, monkeypatch):
    """On a card the engine predicted fastest at the table's size wins;
    every pick gives the host runs engine's pairs.  The bucketed mesh
    search's row, measured with several cards, is a candidate."""
    uniq = _rand_table(6000, seed=1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(B, "_CALIB", dict(calib))
    strategy, pairs = _routed_pairs(monkeypatch, uniq)
    assert strategy == want
    ref = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    np.testing.assert_array_equal(pairs[0], ref[0])
    np.testing.assert_array_equal(pairs[1], ref[1])


def test_host_margin_of_ten_percent(monkeypatch):
    """A device engine must beat the host engine by 10% at the size."""
    c = dict(_HOST_WINS, **_two_point(neighbors_bucketed_ns=95.0))
    monkeypatch.setattr(B, "_CALIB", c)
    assert B.pick_neighbor_engine(CUDA, 10_000) == "runs"
    c.update(_two_point(neighbors_bucketed_ns=89.0))
    assert B.pick_neighbor_engine(CUDA, 10_000) == "bucketed"


def test_forced_engines(monkeypatch):
    """HUMID_TPU_TORCH_DEVICE_ENGINE forces the side: device takes the
    measured best device engine (runs_device without constants, also on
    the CPU), host takes runs everywhere."""
    monkeypatch.setattr(B, "_CALIB", dict(_HOST_WINS))
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE_ENGINE", "1")
    assert B.pick_neighbor_engine(CUDA, 10_000) == "bucketed"
    assert B.pick_neighbor_engine(CPU, 10_000) == "runs_device"
    assert B.use_device_engine("unique", CPU)
    assert B.use_device_engine("cc", CUDA)
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE_ENGINE", "host")
    monkeypatch.setattr(B, "_CALIB", dict(_DEVICE_WINS))
    assert B.pick_neighbor_engine(CUDA, 10_000) == "runs"
    assert not B.use_device_engine("unique", CUDA)
    assert not B.use_fused_pipeline(CUDA, 1 << 20)


def test_calibration_off_takes_the_device_engines(monkeypatch):
    """HUMID_TPU_TORCH_CALIBRATION=off: no constants; a card takes the
    device engines and the fused route, the CPU the host ones."""
    monkeypatch.setenv("HUMID_TPU_TORCH_CALIBRATION", "off")
    assert B.engine_constants(CUDA) is None
    assert B.pick_neighbor_engine(CUDA, 10_000) == "runs_device"
    assert B.use_device_engine("unique", CUDA)
    assert B.use_device_engine("cc", CUDA)
    assert B.use_fused_pipeline(CUDA, 1 << 20)
    assert B.pick_neighbor_engine(CPU, 10_000) == "runs"
    assert not B.use_device_engine("unique", CPU)
    assert not B.use_fused_pipeline(CPU, 1 << 20)
    with pytest.raises(ValueError, match="unknown engine kind"):
        B.use_device_engine("sort", CUDA)


def test_engine_constants_disk_cache(monkeypatch, tmp_path):
    """Constants round-trip through the cache file without a measurement,
    and the comparators read them."""
    (tmp_path / "c.json").write_text(json.dumps({"key": _HOST_WINS,
                                                 "other": {"x": 1}}))
    c = B.engine_constants(CUDA)
    assert c["neighbors_runs_ns"] == [0.0, 100.0]
    assert B.pick_neighbor_engine(CUDA, 10_000) == "runs"
    assert not B.use_device_engine("unique", CUDA)
    assert not B.use_device_engine("cc", CUDA)


def test_measurement_persists_and_keeps_other_rows(monkeypatch, tmp_path):
    """A missing row is measured once (here a stand-in) and written beside
    the rows of other machines; ``refresh`` measures again."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"other": {"x": 1}}))
    calls = []
    monkeypatch.setattr(B, "_measure_engines", lambda device: (
        calls.append(1), dict(_DEVICE_WINS, ts=time.time()))[1])
    assert B.engine_constants(CUDA)["unique_device_ns"] == [0.0, 10.0]
    assert B.engine_constants(CUDA) is B._CALIB and calls == [1]
    on_disk = json.loads(path.read_text())
    assert set(on_disk) == {"other", "key"}
    B._reset_for_tests()
    B.engine_constants(CUDA)
    assert calls == [1]  # read from the file
    B._reset_for_tests()
    B.engine_constants(CUDA, refresh=True)
    assert calls == [1, 1]


def test_stale_row_is_measured_again(monkeypatch):
    """A cached row without the keys a decision needs is measured again."""
    calls = []
    monkeypatch.setattr(B, "_measure_engines", lambda device: (
        calls.append(1), dict(_RUNS_DEVICE_WINS, ts=time.time()))[1])
    monkeypatch.setattr(B, "_CALIB", {"neighbors_runs_ns": [0.0, 1.0],
                                      "ts": 0.0})
    assert B.pick_neighbor_engine(CUDA, 10_000) == "runs_device"
    assert calls == [1]


def test_auto_small_input_stays_dense(monkeypatch):
    monkeypatch.setattr(B, "_CALIB", dict(_DEVICE_WINS))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert N.choose_engine(256, 1, 24, device=CUDA) == "dense"
    assert N.choose_engine(6000, 0, 24, device=CUDA) == "dense"
    assert N.choose_engine(6000, 1, 24, metric="edit", device=CUDA) == "runs"


def test_env_strategy_beats_the_router(monkeypatch):
    monkeypatch.setenv("HUMID_TPU_TORCH_STRATEGY", "bucketed")
    uniq = _rand_table(6000, seed=3)
    info = {}
    N.find_neighbor_pairs(uniq, 1, word_length=24, device="cpu", info=info)
    assert info["strategy"] == "bucketed"


def test_unique_routes_by_constants(monkeypatch):
    """unique_words asks the router above 2^16 rows when given a device:
    the same arrays through the device engine (forced here, on the CPU)
    as through the host engine; HUMID_TPU_TORCH_UNIQUE=host pins the
    host engine."""
    rng = np.random.default_rng(4)
    packed = W.pack_words(rng.integers(0, 4, (70_000, 24)).astype(np.uint8))
    packed[1::3] = packed[0::3][:len(packed[1::3])]
    info = {}
    host = unique_words(packed, device="cpu", info=info)
    assert info["unique"] == "host"
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE_ENGINE", "1")
    dev = unique_words(packed, device="cpu", info=info)
    assert info["unique"] == "device"
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h, d)
    monkeypatch.setenv("HUMID_TPU_TORCH_UNIQUE", "host")
    unique_words(packed, device="cpu", info=info)
    assert info["unique"] == "host"


def _runs_and_bucketed(c):
    return [B.predict_ns(c, "neighbors_runs_ns", 1000),
            B.predict_ns(c, "neighbors_bucketed_ns", 1000)]


def test_noise_guard_tied_backoff(monkeypatch):
    """Engines whose predicted times tie within the measured noise are
    measured once more; a second tie is stamped ``tied_ts`` and later
    processes keep it."""
    tied = dict(_two_point(neighbors_runs_ns=100.0,
                           neighbors_bucketed_ns=105.0), spread=1.0)
    calls = []
    monkeypatch.setattr(B, "_measure_engines", lambda device: (
        calls.append(1), dict(tied, ts=time.time()))[1])
    stale = dict(tied, ts=0.0)
    monkeypatch.setattr(B, "_CALIB", stale)
    c = B._noise_guarded(stale, _runs_and_bucketed, CUDA)
    assert calls == [1] and "tied_ts" in c
    later = dict(c, ts=0.0)
    assert B._noise_guarded(later, _runs_and_bucketed, CUDA) is later
    assert calls == [1]


def test_noise_guard_fresh_or_clear_margin_skips_refresh():
    fresh_tied = dict(_two_point(neighbors_runs_ns=100.0,
                                 neighbors_bucketed_ns=105.0),
                      spread=1.0, ts=time.time())
    assert B._noise_guarded(fresh_tied, _runs_and_bucketed,
                            CUDA) is fresh_tied
    stale_clear = dict(_two_point(neighbors_runs_ns=100.0,
                                  neighbors_bucketed_ns=2000.0),
                       spread=1.0, ts=0.0)
    assert B._noise_guarded(stale_clear, _runs_and_bucketed,
                            CUDA) is stale_clear


def test_noise_guard_reads_predicted_times_at_the_size():
    """Two engines whose fixed and size costs differ tie at one size and
    not at another: the guard compares the predictions, not the raw
    parameters (here a refresh would be refused)."""
    c = {"neighbors_runs_ns": [0.0, 100.0],
         "neighbors_bucketed_ns": [90_000.0, 10.0], "spread": 0.05,
         "ts": 0.0}
    at = lambda u: lambda c: [B.predict_ns(c, "neighbors_runs_ns", u),
                              B.predict_ns(c, "neighbors_bucketed_ns", u)]
    assert B._noise_guarded(c, at(100_000), CUDA) is c   # 10 ms vs 1.09 ms
    with pytest.raises(AssertionError, match="real calibration"):
        B._noise_guarded(c, at(1_000), CUDA)             # 0.1 vs 0.1 ms


def test_use_fused_pipeline_gating(monkeypatch):
    """The variable decides outright; else the fused prediction at the
    run's reads must beat the best phase-wise route (best unique + best
    neighbour engine at the probe's unique share) by 10%; never on the CPU
    device."""
    monkeypatch.setenv("HUMID_TPU_TORCH_FUSED", "1")
    assert B.use_fused_pipeline(CPU, 1000) is True
    monkeypatch.setenv("HUMID_TPU_TORCH_FUSED", "0")
    assert B.use_fused_pipeline(CUDA, 1000) is False
    monkeypatch.delenv("HUMID_TPU_TORCH_FUSED")
    base = dict(_two_point(
        unique_host_ns=20.0, unique_device_ns=100.0, neighbors_runs_ns=100.0,
        neighbors_bucketed_ns=900.0, neighbors_runs_device_ns=300.0,
        cc_host_ns=10.0, cc_device_ns=100.0),
        neighbors_dense_ns=[0.0, 1.0], probe_n=[1000, 4000],
        probe_u=[500, 2000], ts=time.time())
    # The phase-wise alternative: 20 + 100 * 0.5 = 70 ns a read.
    monkeypatch.setattr(B, "_CALIB", dict(base, **_two_point(
        pipeline_fused_ns=50.0)))
    assert B.use_fused_pipeline(CUDA, 1000) is True
    assert B.use_fused_pipeline(CPU, 1000) is False
    monkeypatch.setattr(B, "_CALIB", dict(base, **_two_point(
        pipeline_fused_ns=65.0)))
    assert B.use_fused_pipeline(CUDA, 1000) is False


@pytest.mark.parametrize("fused_share,want", [(0.8, False), (0.6, True)])
def test_fused_decision_is_the_same_on_every_call(fused_share, want,
                                                  monkeypatch):
    """A fused route 20% faster than the phase-wise one, inside a spread
    of 0.3, never takes the fused route, on every one of 100 calls and
    with the row over an hour old (a new measurement would be refused);
    40% faster, outside the spread, always does."""
    row = dict(_phase14_row(), ts=0.0)
    fused, phase_wise = B.fused_times_ns(dict(
        row, pipeline_fused_ns=[0.0, 0.0]), 1_000_000)
    row["pipeline_fused_ns"] = [0.0, fused_share * phase_wise / 1_000_000]
    monkeypatch.setattr(B, "_CALIB", row)
    assert {B.use_fused_pipeline(CUDA, 1_000_000)
            for _ in range(100)} == {want}


def test_phase14_times_pick_dense_then_runs_device(monkeypatch):
    """With the engine times phase 14 measured injected, auto takes the
    dense K1 sweep at the sweep_1M table and runs_device at the sweep_10M
    table on a card, and host runs on the CPU device."""
    monkeypatch.setattr(B, "_CALIB", _phase14_row())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    u_1m, u_10m = _SWEEP_U
    assert B.pick_neighbor_engine(CUDA, u_1m) == "dense"
    assert B.pick_neighbor_engine(CUDA, u_10m) == "runs_device"
    assert N.choose_engine(u_1m, 1, 24, device=CUDA) == "dense"
    assert N.choose_engine(u_10m, 1, 24, device=CUDA) == "runs_device"
    assert N.choose_engine(u_1m, 1, 24, device=CPU) == "runs"
    assert N.choose_engine(u_10m, 1, 24, device=CPU) == "runs"
    times = B.neighbor_times_ns(_phase14_row(), u_1m)
    assert times["dense"] == pytest.approx(6.4e6)


def test_fit_holds_both_parameters_at_or_above_zero():
    assert B._fit([1, 3], [10.0, 30.0], False) == [0.0, 10.0]
    assert B._fit([1, 3], [20.0, 30.0], False) == [15.0, 5.0]
    assert B._fit([1, 3], [30.0, 20.0], False) == [20.0, 0.0]
    assert B._fit([1, 3], [10.0, 90.0], False) == [0.0, 30.0]
    a, c = B._fit([2, 4], [14.0, 26.0], True)
    assert (a, c) == (10.0, 1.0)
    assert B.predict_ns({"neighbors_dense_ns": [a, c]},
                        "neighbors_dense_ns", 10) == 110.0


def test_calibration_version_drops_old_rows(monkeypatch, tmp_path):
    """A cache row written under an older version of the key is not read:
    the router measures again and writes its row beside it."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(B, "_calib_key", CALIB_KEY)
    key = CALIB_KEY(CUDA)
    assert B._CALIB_VERSION == 3 and key.startswith("v3|")
    old_key = "v2|" + key.split("|", 1)[1]
    path = tmp_path / "c.json"
    path.write_text(json.dumps({old_key: {"neighbors_runs_ns": 100.0,
                                          "ts": time.time()}}))
    calls = []
    monkeypatch.setattr(B, "_measure_engines", lambda device: (
        calls.append(1), dict(_DENSE_WINS, ts=time.time()))[1])
    assert B.pick_neighbor_engine(CUDA, 6000) == "dense"
    assert calls == [1]
    assert set(json.loads(path.read_text())) == {old_key, key}


def test_auto_reaches_the_mesh_on_four_faked_cards(monkeypatch):
    """With four cards (faked) and the mesh row the fastest, a bare auto
    with no mesh given takes the bucketed mesh search over all four cards
    (``data_mesh`` of the device), whose pairs equal the host runs
    engine's; the search itself runs here on four CPU shards."""
    from humid_tpu_torch import parallel as P

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(B, "_CALIB", dict(_MESH_WINS))
    seen = []
    real = P.sharded_neighbor_pairs_bucketed

    def on_cpu_shards(packed, max_dist, *, mesh, **kw):
        seen.append(mesh)
        return real(packed, max_dist, mesh=P.data_mesh(len(mesh), "cpu"),
                    **kw)

    monkeypatch.setattr(P, "sharded_neighbor_pairs_bucketed", on_cpu_shards)
    uniq = _rand_table(6000, seed=5)
    info = {}
    got = N.find_neighbor_pairs(uniq, 1, word_length=24, device="cuda",
                                info=info)
    assert info["strategy"] == "sharded_bucketed" and info["shards"] == 4
    assert seen == [tuple(torch.device("cuda", i) for i in range(4))]
    ref = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_the_mesh_row_is_no_multi_process_pick(monkeypatch):
    """Under ``shardable_only`` (a multi-process run) the mesh row is left
    out even where it is the fastest: mesh engines search the whole
    table."""
    monkeypatch.setattr(B, "_CALIB", dict(_MESH_WINS))
    assert B.pick_neighbor_engine(CUDA, 6000) == "sharded_bucketed"
    assert B.pick_neighbor_engine(CUDA, 6000,
                                  shardable_only=True) == "runs_device"


def test_two_probe_measurement_on_the_cpu(monkeypatch):
    """The calibration itself, run on the CPU device at two tiny probes
    (times of no meaning here): every engine gets two parameters, the
    line goes through both probes' times, and the probes' sizes are
    recorded."""
    from humid_tpu_torch.ops import fused

    monkeypatch.setattr(B, "_measure_engines", REAL_MEASURE)
    monkeypatch.setattr(B, "PROBE_READS", (1 << 9, 1 << 10))
    # The fused route's fixed cost on the CPU is most of a second a call;
    # its tests are in test_torch_fused.py.
    monkeypatch.setattr(fused, "fused_probe", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "cpu stand-in")
    c = B._measure_engines(CPU)
    assert c["probe_n"] == [1 << 9, 1 << 10]
    assert c["probe_u"][0] < c["probe_u"][1] < 1 << 10
    rows = {"unique_host_ns", "unique_device_ns", "cc_host_ns",
            "cc_device_ns", "pipeline_fused_ns", *B._SINGLE_CARD_ROWS}
    assert "neighbors_sharded_ns" not in c
    assert set(c["probe_ms"]) == rows
    for k in rows:
        assert min(c[k]) >= 0 and len(c[k]) == 2
        sizes = c["probe_n"] if k in B._PER_READ else c["probe_u"]
        assert c[k] == B._fit(sizes, [t * 1e6 for t in c["probe_ms"][k]],
                              k in B._QUADRATIC)
    assert c["spread"] >= 0 and c["seconds"] > 0


@pytest.mark.parametrize("built", ["hostops", "ccluster", "cfastqio", "all"])
def test_calibration_key_records_the_host_extensions(built, monkeypatch):
    """A cache row measured without a host extension is not read by an
    install that has it: the key differs."""
    from humid_tpu_torch.cluster import exact
    from humid_tpu_torch.io import reader
    from humid_tpu_torch.ops import unique

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    flags = {"hostops": (unique, "_unique_packed"),
             "ccluster": (exact, "_native"),
             "cfastqio": (reader, "_frame_native")}
    for mod, attr in flags.values():
        monkeypatch.setattr(mod, attr, None)
    bare = CALIB_KEY(CUDA)
    for name in (flags if built == "all" else [built]):
        monkeypatch.setattr(*flags[name], object())  # faked as built
    key = CALIB_KEY(CUDA)
    assert bare.startswith(f"v{B._CALIB_VERSION}|") and B._CALIB_VERSION >= 2
    assert bare.endswith("|ext=000") and key != bare
    assert key.endswith("|ext=111") == (built == "all")
