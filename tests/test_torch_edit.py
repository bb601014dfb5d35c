"""The port's edit-distance path (humid_tpu_torch.ops.edit and the edit
engines of humid_tpu_torch.ops.neighbors) against the JAX package's.

Inputs are made with numpy from fixed seeds and fed to both packages; the
port runs on ``device="cpu"``.  The JAX side runs its ``jax.jit`` programs
on the CPU.  Its shifted-segment engine needs a host extension that a
plain checkout does not have, so its dense edit scan is the reference for
both of the port's engines, beside tests/oracle.py's scalar Levenshtein.
Everything compared is integer data: exact equality, tolerance 0.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humid_tpu.ops import edit as JE
from humid_tpu.ops import neighbors as JN
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import edit as E
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import unique_words
from humid_tpu_torch.ops.hamming import lanes_tensor

sys.path.insert(0, os.path.dirname(__file__))
from oracle import _levenshtein  # noqa: E402

CPU = torch.device("cpu")
LENGTHS = [8, 18, 24, 33]
DISTS = [1, 2, 3]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tables here are tiny, and several test processes share the
    machine's cores: with a full thread pool in each, every small CPU op
    waits for threads that are not scheduled.  One thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edited(rng, n, length, m, pool=25):
    """[n, length] uint8 codes: pool words, a third untouched, a third
    with up to m substitutions, a third shifted right by up to m bases
    (an indel at each end)."""
    base = rng.integers(0, 4, (pool, length)).astype(np.uint8)
    codes = base[rng.integers(0, pool, n)].copy()
    for r in range(n):
        op = int(rng.integers(0, 3))
        if op == 1:
            for _ in range(int(rng.integers(1, m + 1))):
                codes[r, int(rng.integers(0, length))] = rng.integers(0, 4)
        elif op == 2:
            d = int(rng.integers(1, m + 1))
            codes[r, d:] = codes[r, :length - d].copy()
            codes[r, :d] = rng.integers(0, 4, d)
    return codes


def _uniq(codes):
    return unique_words(W.pack_words(codes), want_inverse=False)[0]


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64


def _brute_pairs(codes, m):
    words = ["".join("ACGT"[c] for c in row) for row in codes]
    return [(i, j) for i in range(len(words))
            for j in range(i + 1, len(words))
            if _levenshtein(words[i], words[j]) <= m]


@pytest.mark.parametrize("length", LENGTHS + [16, 40])
def test_unpack_matches_reference(length):
    rng = np.random.default_rng(length)
    codes = rng.integers(0, 4, (70, length)).astype(np.uint8)
    codes[0] = 3  # an all-T word: every lane's top bits set
    packed = W.pack_words(codes)
    got = E._unpack(lanes_tensor(packed, CPU), length)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JE._unpack(jnp.asarray(packed), length)))
    np.testing.assert_array_equal(got.numpy(), codes)
    assert got.dtype == torch.int32


def test_unpack_all_t_lanes():
    """0xFFFFFFFF lanes are -1 as int32: the arithmetic shift must still
    give code 3 at every position, the first (shift 30) included."""
    lanes = torch.full((2, 3), -1, dtype=torch.int32)
    assert (E._unpack(lanes, 48) == 3).all()
    assert E._unpack(lanes, 33).shape == (2, 33)


@pytest.mark.parametrize("m", DISTS)
@pytest.mark.parametrize("length", LENGTHS)
def test_banded_levenshtein_matches_reference(length, m):
    rng = np.random.default_rng(100 * m + length)
    a = _edited(rng, 37, length, m, pool=6).astype(np.int32)
    b = _edited(rng, 45, length, m, pool=6).astype(np.int32)
    b[:6] = a[:6]
    want = np.asarray(JE._banded_levenshtein(jnp.asarray(a), jnp.asarray(b),
                                             m, length))
    got = E._banded_levenshtein(torch.from_numpy(a), torch.from_numpy(b),
                                m, length)
    assert got.dtype == torch.int32 and got.shape == (37, 45)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 0 and want.max() == m + 1  # clamped above m
    # The batched form: tile pair t compares a[t] with b[t].
    a3 = np.stack([a[:20], a[17:37]])
    b3 = np.stack([b[:30], b[15:45]])
    got3 = E._banded_levenshtein(torch.from_numpy(a3), torch.from_numpy(b3),
                                 m, length).numpy()
    np.testing.assert_array_equal(got3[0], want[:20, :30])
    np.testing.assert_array_equal(got3[1], want[17:37, 15:45])


@pytest.mark.parametrize("m", DISTS)
@pytest.mark.parametrize("length", LENGTHS)
def test_banded_levenshtein_against_scalar_oracle(length, m):
    rng = np.random.default_rng(7 * m + length)
    a = _edited(rng, 12, length, m, pool=3)
    b = _edited(rng, 14, length, m, pool=3)
    got = E._banded_levenshtein(torch.from_numpy(a.astype(np.int32)),
                                torch.from_numpy(b.astype(np.int32)),
                                m, length).numpy()
    for r in range(12):
        for c in range(14):
            assert got[r, c] == min(_levenshtein(a[r].tolist(),
                                                 b[c].tolist()), m + 1)


@pytest.mark.parametrize("m", DISTS)
@pytest.mark.parametrize("length", LENGTHS)
def test_banded_levenshtein_pairs_matches_reference(length, m):
    rng = np.random.default_rng(200 * m + length)
    a = _edited(rng, 90, length, m, pool=8).astype(np.int32)
    b = _edited(rng, 90, length, m, pool=8).astype(np.int32)
    want = np.asarray(JE._banded_levenshtein_pairs(
        jnp.asarray(a), jnp.asarray(b), m, length))
    got = E._banded_levenshtein_pairs(torch.from_numpy(a),
                                      torch.from_numpy(b), m, length)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The pairwise form is the diagonal of the block form.
    block = E._banded_levenshtein(torch.from_numpy(a), torch.from_numpy(b),
                                  m, length)
    assert torch.equal(got, block.diagonal())


@pytest.mark.parametrize("m", DISTS)
@pytest.mark.parametrize("length", LENGTHS)
def test_edit_block_matches_reference(length, m):
    rng = np.random.default_rng(300 * m + length)
    packed = W.pack_words(_edited(rng, 120, length, m, pool=5))
    rows, cols = packed[:64], packed[40:120]
    for cap in (4096, 7):  # 7: fewer slots than matches
        want = JE.edit_block(jnp.asarray(rows), jnp.asarray(cols), 0, 40, m,
                             cap, length)
        got = E.edit_block(lanes_tensor(rows, CPU), lanes_tensor(cols, CPU),
                           0, 40, m, cap, length)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        assert got[0].dtype == torch.int32
    assert int(got[2]) > 7


@pytest.mark.parametrize("m", DISTS)
@pytest.mark.parametrize("length", LENGTHS)
def test_edit_pairs_verify_matches_reference(length, m):
    rng = np.random.default_rng(400 * m + length)
    codes = _edited(rng, 150, length, m, pool=10)
    packed = W.pack_words(codes)
    a = rng.integers(0, 150, 500).astype(np.int64)
    b = rng.integers(0, 150, 500).astype(np.int64)
    want = JE.edit_pairs_verify(packed, a, b, m, length, batch=128)
    got = E.edit_pairs_verify(packed, a, b, m, length, batch=128,
                              device="cpu")
    _same(got, want)
    assert 0 < len(got[0]) < 500
    whole = E.edit_pairs_verify(packed, a, b, m, length, device="cpu")
    _same(whole, want)  # one batch
    exp = [(int(x), int(y)) for x, y in zip(a, b)
           if _levenshtein(codes[x].tolist(), codes[y].tolist()) <= m]
    assert list(zip(got[0].tolist(), got[1].tolist())) == exp


def test_edit_pairs_verify_no_candidates():
    packed = W.pack_words(np.zeros((3, 24), np.uint8))
    none = np.zeros(0, np.int64)
    a, b = E.edit_pairs_verify(packed, none, none, 1, 24, device="cpu")
    assert len(a) == 0 and len(b) == 0


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("length", [18, 24, 33])
def test_engines_match_reference_dense(length, m):
    """The port's dense scan and shifted-segment search against the JAX
    package's dense edit scan (incl. 3-lane words)."""
    rng = np.random.default_rng(300 + 10 * m + length)
    uniq = _uniq(_edited(rng, 900, length, m))
    want = JN.find_neighbor_pairs(uniq, m, metric="edit", word_length=length,
                                  strategy="dense")
    assert len(want[0]) > 0
    for strategy in ("dense", "runs"):
        info = {}
        _same(N.find_neighbor_pairs(
            uniq, m, metric="edit", word_length=length, strategy=strategy,
            device="cpu", info=info), want)
        assert info["metric"] == "edit" and info["strategy"] == strategy
    assert info["candidates"] > 0
    assert info["join_cap_fallbacks"] == 0


@pytest.mark.parametrize("m", [1, 2, 3])
def test_engines_match_oracle(m):
    rng = np.random.default_rng(50 + m)
    uniq = _uniq(_edited(rng, 260, 20, m, pool=8))
    exp = _brute_pairs(W.unpack_words(uniq, 20), m)
    assert exp
    for strategy in ("dense", "runs"):
        a, b = N.find_neighbor_pairs(uniq, m, metric="edit", word_length=20,
                                     strategy=strategy, device="cpu")
        assert list(zip(a.tolist(), b.tolist())) == exp


def test_dense_scan_matches_edit_block():
    """edit_block over the whole table is the dense scan's oracle, as in
    the JAX package."""
    rng = np.random.default_rng(17)
    uniq = _uniq(_edited(rng, 400, 24, 2, pool=10))
    lanes = lanes_tensor(uniq, CPU)
    r, c, count = E.edit_block(lanes, lanes, 0, 0, 2, 1 << 16, 24)
    a, b = N.dense_edit_pairs(uniq, 2, word_length=24, device="cpu")
    assert int(count) == len(a) > 0
    np.testing.assert_array_equal(r[:len(a)].numpy(), a)
    np.testing.assert_array_equal(c[:len(a)].numpy(), b)


def test_dense_scan_in_several_batches(monkeypatch):
    """A memory budget of one tile pair per pass gives the same pairs."""
    rng = np.random.default_rng(18)
    uniq = _uniq(_edited(rng, 800, 18, 1, pool=200))
    assert len(uniq) > 512  # three tiles of 256 rows, six tile pairs
    want = N.dense_edit_pairs(uniq, 1, word_length=18, tile=256,
                              device="cpu")
    assert len(want[0]) > 0
    calls = []
    monkeypatch.setattr(E, "tile_batch",
                        lambda *a: calls.append(a) or 1)
    _same(N.dense_edit_pairs(uniq, 1, word_length=18, tile=256,
                             device="cpu"), want)
    assert calls


def test_tile_batch_follows_free_memory():
    one = E.tile_batch(CPU, 512, 1)
    assert one >= 1
    assert E.tile_batch(CPU, 256, 1) >= 4 * one - 3
    assert E.tile_batch(CPU, 512, 3) <= one


def test_auto_takes_shifted_above_threshold():
    rng = np.random.default_rng(71)
    uniq = _uniq(_edited(rng, 1500, 24, 1, pool=300))
    assert len(uniq) > 512
    want = N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=24,
                                 strategy="dense", device="cpu")
    info = {}
    _same(N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=24,
                                runs_threshold=512, device="cpu", info=info),
          want)
    assert info["strategy"] == "runs"
    info = {}
    N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=24,
                          device="cpu", info=info)  # below 2,048: dense
    assert info == {"metric": "edit", "strategy": "dense"}


@pytest.mark.parametrize("u,m,length,want", [
    (3000, 1, 24, "runs"), (3000, 0, 24, "dense"), (2048, 1, 24, "dense"),
    (3000, 1, None, "dense")])
def test_choose_engine_edit(u, m, length, want):
    assert N.choose_engine(u, m, length, metric="edit") == want


def _degenerate_table():
    """Every word shares its first segment (the case of the JAX
    package's test_edit_degenerate_join_falls_back_to_dense)."""
    rng = np.random.default_rng(42)
    codes = np.empty((600, 18), np.uint8)
    codes[:, :9] = rng.integers(0, 4, 9).astype(np.uint8)
    codes[:, 9:] = rng.integers(0, 4, (600, 9))
    uniq = _uniq(codes)
    assert len(uniq) > 500
    return uniq


def test_join_cap_falls_back_to_dense_under_auto(monkeypatch):
    uniq = _degenerate_table()
    want = JN.find_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                                  strategy="dense")
    # The cap must trip before the join allocates anything.
    monkeypatch.setattr(N, "_merge_join_numpy", None)
    monkeypatch.setattr(N, "_merge_join_native", None)
    info = {}
    _same(N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                                join_cap=64, runs_threshold=256,
                                device="cpu", info=info), want)
    assert info == {"metric": "edit", "strategy": "dense",
                    "join_cap_fallbacks": 1}


def test_join_cap_is_raised_under_a_forced_runs(monkeypatch):
    uniq = _degenerate_table()
    with pytest.raises(N.JoinCapExceeded, match="join_cap"):
        N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                              strategy="runs", join_cap=64, device="cpu")
    assert issubclass(N.JoinCapExceeded, ValueError)
    # The variable replaces "auto" only as a choice: the engine it names
    # is a forced one.
    monkeypatch.setenv("HUMID_TPU_TORCH_STRATEGY", "runs")
    with pytest.raises(N.JoinCapExceeded):
        N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                              join_cap=64, device="cpu")


@pytest.mark.parametrize("strategy", ["bucketed", "sharded_bucketed", "ring"])
def test_hamming_only_strategies_refuse_edit(strategy):
    uniq = _uniq(_edited(np.random.default_rng(3), 100, 16, 1))
    with pytest.raises(ValueError, match="metric"):
        N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=16,
                              strategy=strategy, device="cpu")


def test_bad_metric_and_missing_word_length():
    uniq = _uniq(_edited(np.random.default_rng(4), 100, 16, 1))
    with pytest.raises(ValueError, match="unknown metric"):
        N.find_neighbor_pairs(uniq, 1, metric="jaccard", word_length=16,
                              device="cpu")
    with pytest.raises(ValueError, match="word_length"):
        N.find_neighbor_pairs(uniq, 1, metric="edit", device="cpu")
    with pytest.raises(ValueError, match="unknown strategy"):
        N.find_neighbor_pairs(uniq, 1, word_length=16, strategy="trie",
                              device="cpu")
    for strategy in ("runs", "runs_device"):  # Hamming pigeonhole engines
        with pytest.raises(ValueError, match="requires word_length"):
            N.find_neighbor_pairs(uniq, 1, strategy=strategy, device="cpu")


def _join_case(rng, n, n_keys, self_join):
    ka = rng.integers(0, n_keys, n).astype(np.uint64)
    kb = ka if self_join else rng.integers(0, n_keys, n).astype(np.uint64)
    if not self_join:
        kb[:5] = ka[:5]  # words that meet themselves under the shifted key
    return ka, np.argsort(ka, kind="stable"), kb, np.argsort(kb, kind="stable")


def _brute_join(ka, kb, self_join):
    want = set()
    for i in range(len(ka)):
        for j in range(len(kb)):
            if ka[i] == kb[j] and i != j:
                want.add((min(i, j), max(i, j)))
    return want


@pytest.mark.parametrize("self_join", [True, False], ids=["self", "cross"])
@pytest.mark.parametrize("n_keys", [1, 7, 60, 1000])
def test_numpy_merge_join_against_brute_force(n_keys, self_join):
    rng = np.random.default_rng(n_keys + self_join)
    ka, oa, kb, ob = _join_case(rng, 120, n_keys, self_join)
    a, b = N._merge_join_numpy(ka, oa, kb, ob, self_join)
    got = list(zip(a.tolist(), b.tolist()))
    want = _brute_join(ka, kb, self_join)
    assert set(got) == want
    assert all(x < y for x, y in got)  # no self pair, (min, max)
    assert len(got) == len(want)  # each unordered pair once
    if self_join:
        assert len(got) == N._join_size(ka[oa], kb[ob], True)
    else:
        assert len(got) <= N._join_size(ka[oa], kb[ob], False)


def test_numpy_merge_join_of_disjoint_and_empty_keys():
    none = np.zeros(0, np.uint64), np.zeros(0, np.int64)
    some = np.array([1, 1, 2], np.uint64), np.arange(3)
    far = np.array([5, 6, 6], np.uint64), np.arange(3)
    for (ka, oa), (kb, ob) in ((none, none), (none, some), (some, none),
                               (some, far)):
        a, b = N._merge_join_numpy(ka, oa, kb, ob, False)
        assert len(a) == 0 and len(b) == 0
        assert N._join_size(ka, kb, False) == 0
    a, b = N._merge_join_numpy(*none, *none, True)
    assert len(a) == 0


@pytest.mark.parametrize("self_join", [True, False], ids=["self", "cross"])
def test_numpy_merge_join_matches_native(self_join):
    if N._merge_join_native is None:
        pytest.skip("humid_tpu_torch._cedit is not built")
    rng = np.random.default_rng(9 + self_join)
    ka, oa, kb, ob = _join_case(rng, 3000, 400, self_join)
    a, b = N._merge_join_numpy(ka, oa, kb, ob, self_join)
    need = N._join_size(ka[oa], kb[ob], self_join)
    na, nb = np.empty(need, np.int64), np.empty(need, np.int64)
    n = N._merge_join_into(ka, oa, kb, ob, ka[oa], kb[ob], self_join, na,
                           nb, "test")
    assert sorted(zip(a.tolist(), b.tolist())) == sorted(
        zip(na[:n].tolist(), nb[:n].tolist()))


def test_merge_join_checks_the_cap_before_it_joins(monkeypatch):
    # The search sizes its joins first: with no join to run, the first
    # join's cap still trips, naming it.
    uniq = _degenerate_table()
    monkeypatch.setattr(N, "_merge_join_numpy", None)
    monkeypatch.setattr(N, "_merge_join_native", None)
    with pytest.raises(N.JoinCapExceeded, match="segment 0, shift 0"):
        N.find_edit_pairs_shifted(uniq, 1, word_length=18, join_cap=100,
                                  device="cpu")


@pytest.mark.parametrize("length", [16, 24, 33])
def test_segment_keys_at_matches_reference(length):
    rng = np.random.default_rng(length)
    uniq = _uniq(_edited(rng, 300, length, 2))
    for lo, hi in ((0, 5), (3, 11), (length - 8, length)):
        np.testing.assert_array_equal(
            N._segment_keys_at(uniq, length, lo, hi),
            JN._segment_keys_at(uniq, length, lo, hi))


def test_join_size_and_run_counts_match_reference():
    rng = np.random.default_rng(6)
    ka = np.sort(rng.integers(0, 40, 500).astype(np.uint64))
    kb = np.sort(rng.integers(20, 70, 400).astype(np.uint64))
    for got, want in zip(N._sorted_run_counts(ka), JN._sorted_run_counts(ka)):
        np.testing.assert_array_equal(got, want)
    assert N._join_size(ka, kb, False) == JN._join_size(ka, kb, False)
    assert N._join_size(ka, ka, True) == JN._join_size(ka, ka, True)
