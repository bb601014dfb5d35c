"""The port's pigeonhole runs engines, device unique counting and device
components against the JAX package's.

Host ``runs`` (humid_tpu_torch.ops.neighbors.find_neighbor_pairs_runs),
device ``runs_device`` (ops/runs_device.py) with its mid-run ladder, the
big-run fallback through the Hamming tile sweep's run-id mask (on the CPU
the sweep's plain version) and the giant-runs dense fallback; the device
unique counting program (ops/unique.py) with words whose bit 31 is set
and an all-T word next to padding; label propagation and the -x finish
(cluster/labelprop.py, cluster/exact.py).  Inputs are made with numpy
from fixed seeds; everything compared is integer data: exact equality.
"""

import numpy as np
import pytest
import torch

from humid_tpu.cluster import exact as JX
from humid_tpu.cluster import labelprop as JL
from humid_tpu.ops import neighbors as JN
from humid_tpu.ops import runs_device as JR
from humid_tpu.ops import unique as JU
from humid_tpu_torch import words as W
from humid_tpu_torch.cluster import exact as X
from humid_tpu_torch.cluster import labelprop as L
from humid_tpu_torch.ops import cuda_hamming as K
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import runs_device as R
from humid_tpu_torch.ops import unique as U


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tables and several test processes on the machine's cores:
    one torch thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, length, n_pool, n_reads, max_subst):
    """Ascending unique packed table from a pool with substitutions."""
    pool = rng.integers(0, 4, (n_pool, length), dtype=np.uint8)
    codes = pool[rng.integers(0, n_pool, n_reads)]
    for _ in range(max_subst):
        hit = rng.random(n_reads) < 0.5
        codes[np.flatnonzero(hit), rng.integers(0, length, int(hit.sum()))] \
            = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
    return U.unique_words(W.pack_words(codes), want_inverse=False)[0]


def _assert_pairs(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("length", [16, 24, 33, 64])  # w = 1, 2, 3, 4
def test_runs_engines_match_reference(length, m):
    """Both runs engines through find_neighbor_pairs == the JAX host runs
    engine (and the JAX device runs engine), with the engine record."""
    rng = np.random.default_rng(10 * m + length)
    uniq = _table(rng, length, 300, 2500, m + 1)
    want = JN.find_neighbor_pairs(uniq, m, word_length=length,
                                  strategy="runs")
    assert len(want[0]) > 0
    for strategy in ("runs", "runs_device"):
        info = {}
        _assert_pairs(N.find_neighbor_pairs(
            uniq, m, word_length=length, strategy=strategy, device="cpu",
            info=info), want)
        assert info["strategy"] == strategy and info["dense_fallbacks"] == 0
        assert info["candidates"] >= len(want[0])
    if length == 24:
        _assert_pairs(JR.runs_device_pairs(uniq, m, word_length=length),
                      want)


def test_mid_runs_on_the_host():
    """d_cap = 1: every run longer than two rows is enumerated on the host
    while the device sweeps offset 1 (as JAX's runs_device_pairs)."""
    rng = np.random.default_rng(3)
    uniq = _table(rng, 24, 60, 3000, 2)
    want = JR.runs_device_pairs(uniq, 1, word_length=24, d_cap=1)
    info = {}
    _assert_pairs(R.runs_device_pairs(uniq, 1, word_length=24, d_cap=1,
                                      device="cpu", info=info), want)
    assert info["d_max"] == 1 and info["candidates"] > len(want[0])


@pytest.mark.parametrize("engine", ["runs", "runs_device"])
def test_big_runs_take_the_tile_sweep_with_ids(engine, monkeypatch):
    """A tiny run_cap sends most runs to _big_run_pairs: the tile sweep
    with its run-id mask (the plain version on the CPU) over the tiles
    they span; pairs == the JAX runs engine at the same run_cap."""
    rng = np.random.default_rng(4)
    uniq = _table(rng, 24, 40, 3000, 2)
    want = JN.find_neighbor_pairs_runs(uniq, 1, word_length=24, run_cap=6,
                                       tile=256)
    calls = []
    real = K.hamming_tile_pairs

    def sweep(lanes, tp, **kw):
        calls.append(kw["ids"] is not None)
        return real(lanes, tp, **kw)

    monkeypatch.setattr(N, "hamming_tile_pairs", sweep)
    fn = (N.find_neighbor_pairs_runs if engine == "runs"
          else R.runs_device_pairs)
    info = {}
    _assert_pairs(fn(uniq, 1, word_length=24, run_cap=6, tile=256,
                     device="cpu", info=info), want)
    assert calls == [True] and info["dense_fallbacks"] == 0


@pytest.mark.parametrize("engine", ["runs", "runs_device"])
def test_giant_runs_fall_back_to_dense(engine):
    """One template with substitutions in two positions only: giant runs
    in both partitions cover more rows than the table; the engines go to
    one dense sweep and record it."""
    rng = np.random.default_rng(11)
    codes = np.tile(rng.integers(0, 4, 24, dtype=np.uint8), (3000, 1))
    codes[np.arange(3000), rng.integers(0, 2, 3000)] = rng.integers(
        0, 4, 3000, dtype=np.uint8)
    codes[np.arange(3000), 20 + rng.integers(0, 2, 3000)] = rng.integers(
        0, 4, 3000, dtype=np.uint8)
    uniq = U.unique_words(W.pack_words(codes), want_inverse=False)[0]
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="dense",
                                  impl="xor")
    fn = (N.find_neighbor_pairs_runs if engine == "runs"
          else R.runs_device_pairs)
    info = {}
    _assert_pairs(fn(uniq, 1, word_length=24, run_cap=4, device="cpu",
                     info=info), want)
    assert info["dense_fallbacks"] == 1


def test_unsorted_table_goes_to_the_host_engine():
    """runs_device takes partition 0 in table order; a table that does not
    ascend is handed to the host engine instead of losing pairs."""
    rng = np.random.default_rng(6)
    uniq = _table(rng, 24, 200, 2000, 2)
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    perm = rng.permutation(len(uniq))
    got = R.runs_device_pairs(uniq[perm], 1, word_length=24, device="cpu")
    a, b = perm[got[0]], perm[got[1]]
    _assert_pairs(N._dedupe_pairs(np.minimum(a, b), np.maximum(a, b)), want)


def test_run_pair_helpers_match_reference():
    """_run_pairs_fallback (vectorized here, a loop there) gives the same
    arrays in the same order; _filter_hamming_host, _combined_u64 and
    _identity_runs agree too."""
    rng = np.random.default_rng(7)
    uniq = _table(rng, 24, 100, 2000, 2)
    key = N._segment_run_ids(uniq, 24, 2)[1]
    order, starts, lens = N._partition_runs(key)
    sel = lens >= 2
    for got, want in zip(N._run_pairs_fallback(order, starts[sel], lens[sel]),
                         JN._run_pairs_fallback(order, starts[sel],
                                                lens[sel])):
        np.testing.assert_array_equal(got, want)
    a, b = JN._run_pairs_fallback(order, starts[sel], lens[sel])
    for m in (0, 1, 2):
        _assert_pairs(N._filter_hamming_host(uniq, a, b, m),
                      JN._filter_hamming_host(uniq, a, b, m))
    np.testing.assert_array_equal(N._combined_u64(uniq),
                                  JN._combined_u64(uniq))
    key0 = N._segment_run_ids(uniq, 24, 2)[0]
    for got, want in zip(N._identity_runs(key0), JN._identity_runs(key0)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(N._identity_runs(key), JN._identity_runs(key)):
        np.testing.assert_array_equal(got, want)  # unsorted: sorts


@pytest.mark.parametrize("length,n_seg", [(16, 2), (24, 3), (33, 2),
                                          (64, 4)])
def test_runs_eval_matches_reference(length, n_seg):
    """_runs_eval's bitmap bytes == the JAX program's uint32 words, and
    _bitmap_positions decodes both alike; segment masks agree."""
    rng = np.random.default_rng(length + n_seg)
    uniq = _table(rng, length, 150, 1500, 2)
    w = uniq.shape[1]
    masks = R.segment_lane_masks(length, n_seg, w)
    np.testing.assert_array_equal(masks, JR.segment_lane_masks(length, n_seg,
                                                               w))
    u = len(uniq)
    n = JR._quantize_n(u)
    rows = np.zeros((n, w), np.uint32)
    rows[:u] = uniq
    keys = N._segment_run_ids(uniq, length, n_seg)
    orders = np.zeros((n_seg - 1, n), np.int32)
    for p in range(1, n_seg):
        orders[p - 1, :u] = N._partition_runs(keys[p])[0]
    want = np.asarray(JR._runs_eval(
        rows, orders, masks, np.zeros((1, 1), np.uint8), u, 2, d_max=4,
        n_seg=n_seg, w=w, with_owned=False))
    lanes = torch.from_numpy(rows.view(np.int32))
    got, matches = R._runs_eval(lanes, torch.from_numpy(orders).long(),
                                torch.from_numpy(masks.view(np.int32)), u, 2,
                                d_hi=4, with_matches=True)
    np.testing.assert_array_equal(got.numpy(), want.view(np.uint8))
    assert int(matches.sum()) > 0
    for p in range(n_seg):
        for d in range(4):
            np.testing.assert_array_equal(
                R._bitmap_positions(got[p, d].numpy(), u),
                JR._bitmap_positions(want[p, d], u))


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5])
def test_unique_words_device_matches_reference(w):
    """Device unique counting (on the CPU) == the JAX package's
    unique_words: uniques ascending as uint32, counts, first occurrences,
    inverse; words with bit 31 set and all-T words among them."""
    rng = np.random.default_rng(40 + w)
    pool = rng.integers(0, 2 ** 32, (400, w), dtype=np.uint64).astype(
        np.uint32)
    pool[:3] = 0xFFFFFFFF
    pool[3:9, 0] = 0x80000000 | pool[3:9, 0]
    pool[9:12] = 0
    packed = pool[rng.integers(0, len(pool), 6000)]
    want = JU.unique_words(packed, want_inverse=True)
    for want_inverse in (True, False):
        got = U.unique_words_device(packed, want_inverse, device="cpu")
        for g, x in zip(got[:3], want[:3]):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
        if want_inverse:
            np.testing.assert_array_equal(got[3], want[3])
        else:
            assert got[3] is None


def test_unique_program_fences_padding_off_an_all_t_word():
    """Padding rows (all ones) after the real rows, an all-T word among
    the real ones: the first n sorted rows are the real ones, the all-T
    group counts only real rows, the table's tail stays all ones."""
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 2 ** 32, (500, 2), dtype=np.uint64).astype(
        np.uint32)
    packed[[3, 77, 400]] = 0xFFFFFFFF
    want = JU.unique_words(packed, want_inverse=True)
    lanes = torch.from_numpy(np.concatenate(
        [packed, np.full((92, 2), 0xFFFFFFFF, np.uint32)]).view(np.int32))
    uniq, counts, first, inv, k = U._unique_program(lanes, 500, True)
    k = int(k)
    assert k == len(want[0]) and int(counts[k - 1]) == 3
    np.testing.assert_array_equal(uniq[:k].numpy().view(np.uint32), want[0])
    assert bool((uniq[k:] == -1).all())
    np.testing.assert_array_equal(counts[:k].numpy(), want[1])
    np.testing.assert_array_equal(first[:k].numpy(), want[2])
    np.testing.assert_array_equal(inv.numpy(), want[3])


def test_unique_words_routes_by_variable(monkeypatch):
    """HUMID_TPU_TORCH_UNIQUE picks the engine (recorded in info); without
    it and without a device the host engine runs; both give the same
    arrays."""
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 2 ** 32, (3000, 2), dtype=np.uint64).astype(
        np.uint32)[rng.integers(0, 3000, 9000)]
    info = {}
    host = U.unique_words(packed, info=info)
    assert info == {"unique": "host"}
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv(U.UNIQUE_ENV_VAR, "device")
    dev = U.unique_words(packed, info=info)
    assert info == {"unique": "device"}
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h, d)


def _components(a, b, n):
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for x, y in zip(a.tolist(), b.tolist()):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[max(rx, ry)] = min(rx, ry)
    return np.array([find(i) for i in range(n)])


def test_connected_components_and_max_finish_match_reference():
    """Device components == JAX's labelprop == union-find; the -x finish
    from them == the JAX finish == the host exact -x walk (a table whose
    components share max counts, so the DFS tie-break re-walk runs)."""
    rng = np.random.default_rng(12)
    uniq = _table(rng, 24, 200, 4000, 2)
    a, b = N.find_neighbor_pairs(uniq, 2, word_length=24, strategy="runs",
                                 device="cpu")
    u = len(uniq)
    cc = L.connected_components_device(a, b, u, device="cpu")
    np.testing.assert_array_equal(cc, JL.connected_components_device(a, b, u))
    np.testing.assert_array_equal(cc, _components(a, b, u))
    counts = rng.integers(1, 4, u).astype(np.int64)  # ties in most comps
    indptr, indices = N.pairs_to_csr(a, b, u)
    got = X.cluster_max_from_components(counts, indptr, indices, cc)
    want = JX.cluster_max_from_components(counts, indptr, indices,
                                          JL.connected_components_device(
                                              a, b, u))
    host = X.cluster_exact(counts, indptr, indices, maximum=True)
    for field in ("labels", "max_leaf", "max_count", "size"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(host, field))
    for got_r, want_r in zip(L.renumber_components(cc),
                             JL.renumber_components(cc)):
        np.testing.assert_array_equal(got_r, want_r)
    assert len(L.connected_components_device(a[:0], b[:0], 5, "cpu")) == 5
    assert len(L.connected_components_device(a[:0], b[:0], 0, "cpu")) == 0
