"""The port's fused device-resident route (humid_tpu_torch/ops/fused.py)
against the JAX package's (humid_tpu/ops/fused.py) on the CPU.

The cases of tests/test_fused.py, mirrored: the same packed reads pushed
into both packages' feeders in the same uneven batches (a small estimate
and chunk: growth, chunks that split batches, a short last flush), then
the unique table, counts, first occurrences, inverse, neighbour pairs and
-x component labels compared exactly; the CLI through the fused route
against baseline/humid_ref and the JAX package's CLI; and the capacity
fallback through run().  Inputs come from fixed numpy seeds.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from humid_tpu import words as JW
from humid_tpu.ops import fused as JF
from humid_tpu.ops import neighbors as JN
from humid_tpu.ops import unique_words as j_unique_words
from humid_tpu_torch.ops import fused as F

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402
from test_golden import CASES  # noqa: E402
from test_torch_pipeline import (_assert_same_dirs, _dataset,  # noqa: E402
                                 _run_port, _run_ref, humid_ref)  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tables and several test processes on the machine's cores:
    one torch thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen_packed(n, wl, dup=6, seed=0, mut_p=0.3):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, size=(max(n // dup, 1), wl)).astype(np.uint8)
    codes = pool[rng.integers(0, len(pool), n)].copy()
    mut = rng.random(n) < mut_p
    if mut.any():
        codes[np.flatnonzero(mut), rng.integers(0, wl, int(mut.sum()))] = (
            rng.integers(0, 4, int(mut.sum())))
    return JW.pack_words(codes)


def _push(feeder, packed, filtered, seed):
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(packed):
        j = min(len(packed), i + int(rng.integers(1, 700)))
        keep = ~filtered[i:j]
        feeder.push(packed[i:j][keep] if not keep.all() else packed[i:j])
        i = j


def _run_both(packed, wl, m, *, filtered=None, want_inverse=False,
              want_labels=False, seed=1, **kw):
    """(port FusedPipeline, JAX FusedPipeline) after unique(), fed alike."""
    n, w = packed.shape
    if filtered is None:
        filtered = np.zeros(n, bool)
    out = []
    for mod, extra in ((F, {"device": "cpu"}), (JF, {})):
        feeder = mod.DeviceFeeder(w, max(n // 3, 1), chunk_rows=1024, **extra)
        _push(feeder, packed, filtered, seed)
        fp = mod.FusedPipeline(feeder, n, filtered, word_length=wl,
                               max_dist=m, want_inverse=want_inverse,
                               want_labels=want_labels, **kw)
        fp.unique()
        out.append(fp)
    return out


def _assert_same(port, jax_fp, info):
    assert port.k == jax_fp.k
    for got, want in zip(port.tables(), jax_fp.tables()):
        if want is None:
            assert got is None
        else:
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
    pairs = port.neighbors(info=info)
    want = jax_fp.neighbors()
    np.testing.assert_array_equal(pairs[0], want[0])
    np.testing.assert_array_equal(pairs[1], want[1])
    np.testing.assert_array_equal(port.table(), jax_fp.table())
    assert info["strategy"] == "fused"
    if port.k > 1 and info["decode"] != "dense":
        assert info["d_max"] == JN.LAST_DECISION["d_max"]
    return pairs


@pytest.mark.parametrize("wl,m,n,seed", [
    (24, 1, 12_000, 0),
    (24, 2, 5_000, 1),
    (24, 3, 3_000, 2),
    (16, 1, 8_000, 3),
    (8, 2, 4_000, 4),     # tiny words: huge runs
    (33, 1, 5_000, 5),    # 3 lanes
    (64, 2, 3_000, 6),    # 4 lanes
    (2, 3, 2_000, 8),     # more segments than bases: empty segments
])
def test_fused_matches_reference(wl, m, n, seed):
    packed = _gen_packed(n, wl, seed=seed)
    port, jax_fp = _run_both(packed, wl, m)
    pairs = _assert_same(port, jax_fp, {})
    uniq = j_unique_words(packed, want_inverse=False)[0]
    want = JN.find_neighbor_pairs(uniq, m, strategy="runs", word_length=wl)
    np.testing.assert_array_equal(pairs[0], want[0])
    np.testing.assert_array_equal(pairs[1], want[1])


def test_fused_filtered_and_inverse():
    wl, m, n = 24, 1, 15_000
    packed = _gen_packed(n, wl, seed=7)
    filtered = np.random.default_rng(8).random(n) < 0.15
    port, jax_fp = _run_both(packed, wl, m, filtered=filtered,
                             want_inverse=True)
    _assert_same(port, jax_fp, {})
    assert (port.tables()[2] == -1).sum() == filtered.sum()


def test_fused_mid_and_big_runs(monkeypatch):
    """d_cap = 1 sends runs of more than two rows to the host ladder, a
    tiny run_cap sends most of them to the tile sweep with its run-id
    mask; the decode is then full."""
    from humid_tpu_torch.ops import neighbors as N

    calls = []
    real = N.hamming_tile_pairs
    monkeypatch.setattr(N, "hamming_tile_pairs", lambda *a, **kw: (
        calls.append(kw["ids"] is not None), real(*a, **kw))[1])
    packed = _gen_packed(5_000, 24, dup=40, seed=9, mut_p=0.6)
    port, jax_fp = _run_both(packed, 24, 1, d_cap=1, run_cap=12)
    info = {}
    _assert_same(port, jax_fp, info)
    assert info["d_max"] == 1 and info["decode"] == "full"
    assert calls == [True]


def test_fused_sparse_decode_with_mid_runs():
    """Rare mid runs on a sparse table: the sparse decode gathers only the
    mid-run members' rows; the table never comes to the host."""
    wl, m = 24, 1
    rng = np.random.default_rng(15)
    codes = rng.integers(0, 4, size=(20_000, wl)).astype(np.uint8)
    for g in range(30):  # runs of 6 rows in partition 0, < 1% of the table
        codes[200 * g:200 * g + 6, :12] = codes[200 * g, :12]
    packed = JW.pack_words(codes)
    port, jax_fp = _run_both(packed, wl, m, d_cap=2)
    info = {}
    pairs = port.neighbors(info=info)
    assert info["decode"] == "sparse" and info["d_max"] == 2
    assert port.uniq is None  # the table never came down
    want = jax_fp.neighbors()
    np.testing.assert_array_equal(pairs[0], want[0])
    np.testing.assert_array_equal(pairs[1], want[1])


def test_fused_degenerate_dense_fallback():
    """Giant runs in both partitions: the dense sweep, recorded."""
    wl = 24
    rng = np.random.default_rng(11)
    codes = np.tile(rng.integers(0, 4, wl).astype(np.uint8), (4_000, 1))
    codes[np.arange(4_000), rng.integers(0, 2, 4_000)] = rng.integers(
        0, 4, 4_000)
    codes[np.arange(4_000), 20 + rng.integers(0, 2, 4_000)] = rng.integers(
        0, 4, 4_000)
    packed = JW.pack_words(codes)
    port, jax_fp = _run_both(packed, wl, 1, run_cap=2)
    info = {}
    _assert_same(port, jax_fp, info)
    assert info["decode"] == "dense" and info["dense_fallbacks"] == 1


def test_fused_device_labels_match_reference():
    """-x: labels propagated over the resident matches and the uploaded
    mid and big-run edges == the JAX program D == connected components of
    the pairs; the finished -x clustering == the host walk."""
    from humid_tpu_torch.cluster import (cluster_exact,
                                         cluster_max_from_components,
                                         connected_components_device)
    from humid_tpu_torch.ops import pairs_to_csr

    wl, m = 24, 2
    packed = _gen_packed(12_000, wl, seed=12)
    port, jax_fp = _run_both(packed, wl, m, want_labels=True, d_cap=2,
                             run_cap=64)
    pa, pb = _assert_same(port, jax_fp, {})
    assert port.has_matches
    cc = port.device_labels()
    assert cc.dtype == np.int64
    np.testing.assert_array_equal(cc, jax_fp.device_labels())
    np.testing.assert_array_equal(
        cc, connected_components_device(pa, pb, port.k, device="cpu"))
    counts = port.tables()[0]
    indptr, indices = pairs_to_csr(pa, pb, port.k)
    host = cluster_exact(counts, indptr, indices, maximum=True)
    dev = cluster_max_from_components(counts, indptr, indices, cc)
    for field in ("labels", "max_leaf", "max_count", "size"):
        np.testing.assert_array_equal(getattr(host, field),
                                      getattr(dev, field))


def test_fused_empty_and_single_word():
    wl = 24
    packed = _gen_packed(500, wl, seed=13)
    port, jax_fp = _run_both(packed, wl, 1, filtered=np.ones(500, bool),
                             want_inverse=True)
    assert port.k == 0
    counts, first, inv = port.tables()
    assert len(counts) == 0 and len(first) == 0 and np.all(inv == -1)
    assert len(port.neighbors()[0]) == 0
    packed = np.tile(_gen_packed(1, wl, seed=14), (300, 1))
    port, jax_fp = _run_both(packed, wl, 1)
    _assert_same(port, jax_fp, {})
    assert port.k == 1


def test_feeder_positions_and_growth():
    """Rows land at their usable-read index across split chunks and
    growth; unwritten rows are all ones (they sort last)."""
    rng = np.random.default_rng(31)
    n, w = 5_000, 2
    packed = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)
    feeder = F.DeviceFeeder(w, 64, device="cpu", chunk_rows=512)
    assert feeder.cap == 512
    i = 0
    while i < n:
        j = min(n, i + int(rng.integers(1, 300)))
        feeder.push(packed[i:j])
        i = j
    buf = feeder.finish().numpy().view(np.uint32)
    assert feeder.n == n and feeder.cap == 8192
    np.testing.assert_array_equal(buf[:n], packed)
    assert np.all(buf[n:] == 0xFFFFFFFF)
    with pytest.raises(RuntimeError, match="after finish"):
        feeder.push(packed[:1])


def test_fused_probe_matches_host():
    from humid_tpu_torch.ops import find_neighbor_pairs, unique_words

    packed = _gen_packed(300_000, 24, seed=21)  # three batches
    k, counts, first, (pa, pb) = F.fused_probe(packed, 24, 1, device="cpu")
    uniq, want_counts, want_first, _ = unique_words(packed)
    want = find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs",
                               device="cpu")
    assert k == len(uniq)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(first, want_first)
    np.testing.assert_array_equal(pa, want[0])
    np.testing.assert_array_equal(pb, want[1])


HAMMING = {i: c for i, c in zip(
    ["single", "paired_umi", "colon_gz", "threefile", "m2", "max", "m0",
     "m3", "n16", "n80", "n0", "ragged_n", "unequal", "word_gt_read",
     "max_m2_ragged"], [c for c in CASES if "-e" not in c[4]])}


@pytest.mark.parametrize("name", ["single", "paired_umi", "max", "m3",
                                  "ragged_n", "max_m2_ragged"])
def test_fused_cli_matches_humid_ref(name, humid_ref, tmp_path,
                                     monkeypatch):
    """python -m humid_tpu_torch with HUMID_TPU_TORCH_FUSED=1 on the CPU
    writes baseline/humid_ref's bytes on the golden cases."""
    from humid_tpu_torch import cli, pipeline

    files, extra = _dataset(HAMMING[name], tmp_path)
    _run_ref(humid_ref, tmp_path / "ref", ["-s", "-a", *extra], files)
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("HUMID_TPU_TORCH_FUSED", "1")
    results = []
    monkeypatch.setattr(
        cli, "run", lambda *a, **k: results.append(pipeline.run(*a, **k)))
    _run_port(tmp_path / "port", ["-s", "-a", *extra], files)
    engine = results[0].extra["engine"]
    assert engine["unique"] == "fused" and engine["fused_fallback"] == 0
    assert engine["strategy"] == "fused"
    _assert_same_dirs(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize("maximum", [False, True], ids=["directional", "max"])
def test_fused_run_matches_humid_tpu(maximum, tmp_path, monkeypatch):
    """run() through the fused route == the JAX package's run() through its
    fused route, on filtered (N-containing) reads, with -x the labels from
    program D."""
    import humid_tpu
    import humid_tpu_torch

    gen_dataset(np.random.default_rng(21), str(tmp_path), n_reads=1500,
                n_files=2, umi_style="underscore", ragged=True, n_frac=0.1)
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    kw = dict(log_name=os.devnull, write_annotated=True, run_stats=True,
              maximum=maximum)
    monkeypatch.setenv("HUMID_TPU_FUSED", "1")
    humid_tpu.run(files, dir_name=str(tmp_path / "jax"), **kw)
    monkeypatch.setenv("HUMID_TPU_TORCH_FUSED", "1")
    res = humid_tpu_torch.run(files, dir_name=str(tmp_path / "port"),
                              device="cpu", **kw)
    assert res.extra["engine"]["strategy"] == "fused"
    assert res.extra["engine"].get("components") == (
        "fused" if maximum else None)
    _assert_same_dirs(tmp_path / "jax", tmp_path / "port")


def test_fused_capacity_fallback(tmp_path, monkeypatch):
    """Growth past the device budget (the estimate undershot) sends the run
    back through the host pass-1 path with fresh caches: the same bytes,
    and the fallback recorded."""
    import humid_tpu_torch
    from humid_tpu_torch import pipeline as P

    gen_dataset(np.random.default_rng(55), str(tmp_path), n_reads=3000,
                n_files=1, umi_style="none")
    files = [str(tmp_path / "file0.fastq")]
    kw = dict(log_name=os.devnull, write_annotated=True, run_stats=True,
              device="cpu")
    humid_tpu_torch.run(files, dir_name=str(tmp_path / "ref"), **kw)
    monkeypatch.setenv("HUMID_TPU_TORCH_FUSED", "1")
    monkeypatch.setattr(P, "_input_bytes_estimate", lambda files: 1)
    monkeypatch.setattr(F, "DeviceFeeder",
                        functools.partial(F.DeviceFeeder, chunk_rows=256))
    monkeypatch.setattr(F, "fused_fits", lambda rows, w, device: rows <= 1024)
    res = humid_tpu_torch.run(files, dir_name=str(tmp_path / "fb"), **kw)
    assert res.extra["engine"]["fused_fallback"] == 1
    assert res.extra["engine"]["strategy"] != "fused"
    assert res.extra["engine"]["unique"] == "host"
    _assert_same_dirs(tmp_path / "ref", tmp_path / "fb")


def test_fused_route_excluded_by_overrides(tmp_path, monkeypatch):
    """-e, -m 0, neighbor_opts and the strategy and unique variables keep
    the phase-wise route even when the fused one is forced."""
    import humid_tpu_torch

    gen_dataset(np.random.default_rng(57), str(tmp_path), n_reads=400,
                n_files=1, umi_style="none")
    files = [str(tmp_path / "file0.fastq")]
    monkeypatch.setenv("HUMID_TPU_TORCH_FUSED", "1")
    kw = dict(log_name=os.devnull, write_dedup=False, device="cpu")
    for opts, env in (({"edit": True}, {}), ({"distance": 0}, {}),
                      ({"neighbor_opts": {"strategy": "dense"}}, {}),
                      ({}, {"HUMID_TPU_TORCH_STRATEGY": "dense"}),
                      ({}, {"HUMID_TPU_TORCH_UNIQUE": "host"})):
        with monkeypatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            res = humid_tpu_torch.run(files, dir_name=str(tmp_path / "o"),
                                      **kw, **opts)
        assert res.extra["engine"]["unique"] != "fused", (opts, env)
        assert "fused_fallback" not in res.extra["engine"]
