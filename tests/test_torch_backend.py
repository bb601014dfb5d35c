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
#: The real cache key (the fixture below replaces it).
CALIB_KEY = B._calib_key


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


_DEVICE_WINS = {
    "unique_host_ns": 100.0, "unique_device_ns": 10.0,
    "neighbors_runs_ns": 1000.0, "neighbors_bucketed_ns": 100.0,
    "neighbors_runs_device_ns": 2000.0,
    "cc_host_ns": 100.0, "cc_device_ns": 10.0, "ts": time.time(),
}
_HOST_WINS = {
    "unique_host_ns": 10.0, "unique_device_ns": 100.0,
    "neighbors_runs_ns": 100.0, "neighbors_bucketed_ns": 1000.0,
    "neighbors_runs_device_ns": 2000.0,
    "cc_host_ns": 10.0, "cc_device_ns": 100.0, "ts": time.time(),
}
_RUNS_DEVICE_WINS = dict(_DEVICE_WINS, neighbors_runs_device_ns=50.0)
_MESH_WINS = dict(_DEVICE_WINS, neighbors_sharded_ns=20.0,
                  neighbors_runs_device_ns=50.0)


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
    (_MESH_WINS, "runs_device"), (_HOST_WINS, "runs")],
    ids=["bucketed", "runs_device", "mesh", "host"])
def test_auto_follows_the_measured_constants(calib, want, monkeypatch):
    """On a card the measured fastest engine wins; every pick gives the
    host runs engine's pairs.  The bucketed mesh search's row, measured
    with several cards, is not a candidate even when it is the fastest."""
    uniq = _rand_table(6000, seed=1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(B, "_CALIB", dict(calib))
    strategy, pairs = _routed_pairs(monkeypatch, uniq)
    assert strategy == want
    ref = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    np.testing.assert_array_equal(pairs[0], ref[0])
    np.testing.assert_array_equal(pairs[1], ref[1])


def test_host_margin_of_ten_percent(monkeypatch):
    """A device engine must beat the host engine by 10%."""
    c = dict(_HOST_WINS, neighbors_bucketed_ns=95.0)
    monkeypatch.setattr(B, "_CALIB", c)
    assert B.pick_neighbor_engine(CUDA) == "runs"
    c["neighbors_bucketed_ns"] = 89.0
    assert B.pick_neighbor_engine(CUDA) == "bucketed"


def test_forced_engines(monkeypatch):
    """HUMID_TPU_TORCH_DEVICE_ENGINE forces the side: device takes the
    measured best device engine (runs_device without constants, also on
    the CPU), host takes runs everywhere."""
    monkeypatch.setattr(B, "_CALIB", dict(_HOST_WINS))
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE_ENGINE", "1")
    assert B.pick_neighbor_engine(CUDA) == "bucketed"
    assert B.pick_neighbor_engine(CPU) == "runs_device"
    assert B.use_device_engine("unique", CPU)
    assert B.use_device_engine("cc", CUDA)
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE_ENGINE", "host")
    monkeypatch.setattr(B, "_CALIB", dict(_DEVICE_WINS))
    assert B.pick_neighbor_engine(CUDA) == "runs"
    assert not B.use_device_engine("unique", CUDA)
    assert not B.use_fused_pipeline(CUDA)


def test_calibration_off_takes_the_device_engines(monkeypatch):
    """HUMID_TPU_TORCH_CALIBRATION=off: no constants; a card takes the
    device engines and the fused route, the CPU the host ones."""
    monkeypatch.setenv("HUMID_TPU_TORCH_CALIBRATION", "off")
    assert B.engine_constants(CUDA) is None
    assert B.pick_neighbor_engine(CUDA) == "runs_device"
    assert B.use_device_engine("unique", CUDA)
    assert B.use_device_engine("cc", CUDA)
    assert B.use_fused_pipeline(CUDA)
    assert B.pick_neighbor_engine(CPU) == "runs"
    assert not B.use_device_engine("unique", CPU)
    assert not B.use_fused_pipeline(CPU)
    with pytest.raises(ValueError, match="unknown engine kind"):
        B.use_device_engine("sort", CUDA)


def test_engine_constants_disk_cache(monkeypatch, tmp_path):
    """Constants round-trip through the cache file without a measurement,
    and the comparators read them."""
    (tmp_path / "c.json").write_text(json.dumps({"key": _HOST_WINS,
                                                 "other": {"x": 1}}))
    c = B.engine_constants(CUDA)
    assert c["neighbors_runs_ns"] == 100.0
    assert B.pick_neighbor_engine(CUDA) == "runs"
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
    assert B.engine_constants(CUDA)["unique_device_ns"] == 10.0
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
    monkeypatch.setattr(B, "_CALIB", {"neighbors_runs_ns": 1.0, "ts": 0.0})
    assert B.pick_neighbor_engine(CUDA) == "runs_device"
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


def test_noise_guard_tied_backoff(monkeypatch):
    """Engines tied within the measured noise are measured once more; a
    second tie is stamped ``tied_ts`` and later processes keep it."""
    tied = {"neighbors_runs_ns": 100.0, "neighbors_bucketed_ns": 105.0,
            "spread": 1.0}
    calls = []
    monkeypatch.setattr(B, "_measure_engines", lambda device: (
        calls.append(1), dict(tied, ts=time.time()))[1])
    stale = dict(tied, ts=0.0)
    monkeypatch.setattr(B, "_CALIB", stale)
    ks = ["neighbors_runs_ns", "neighbors_bucketed_ns"]
    c = B._noise_guarded(stale, ks, CUDA)
    assert calls == [1] and "tied_ts" in c
    later = dict(c, ts=0.0)
    assert B._noise_guarded(later, ks, CUDA) is later
    assert calls == [1]


def test_noise_guard_fresh_or_clear_margin_skips_refresh():
    ks = ["neighbors_runs_ns", "neighbors_bucketed_ns"]
    fresh_tied = {"neighbors_runs_ns": 100.0, "neighbors_bucketed_ns": 105.0,
                  "spread": 1.0, "ts": time.time()}
    assert B._noise_guarded(fresh_tied, ks, CUDA) is fresh_tied
    stale_clear = {"neighbors_runs_ns": 100.0,
                   "neighbors_bucketed_ns": 2000.0, "spread": 1.0, "ts": 0.0}
    assert B._noise_guarded(stale_clear, ks, CUDA) is stale_clear


def test_use_fused_pipeline_gating(monkeypatch):
    """The variable decides outright; else the fused constant must beat the
    best phase-wise route (best unique + best neighbour engine per read)
    by 10%; never on the CPU device."""
    monkeypatch.setenv("HUMID_TPU_TORCH_FUSED", "1")
    assert B.use_fused_pipeline(CPU) is True
    monkeypatch.setenv("HUMID_TPU_TORCH_FUSED", "0")
    assert B.use_fused_pipeline(CUDA) is False
    monkeypatch.delenv("HUMID_TPU_TORCH_FUSED")
    base = {"unique_host_ns": 20.0, "unique_device_ns": 100.0,
            "neighbors_runs_ns": 100.0, "neighbors_bucketed_ns": 900.0,
            "neighbors_runs_device_ns": 300.0, "cc_host_ns": 10.0,
            "cc_device_ns": 100.0, "probe_n": 1000, "probe_u": 500,
            "ts": time.time()}
    # The phase-wise alternative: 20 + 100 * 0.5 = 70 ns a read.
    monkeypatch.setattr(B, "_CALIB", dict(base, pipeline_fused_ns=50.0))
    assert B.use_fused_pipeline(CUDA) is True
    assert B.use_fused_pipeline(CPU) is False
    monkeypatch.setattr(B, "_CALIB", dict(base, pipeline_fused_ns=65.0))
    assert B.use_fused_pipeline(CUDA) is False


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
