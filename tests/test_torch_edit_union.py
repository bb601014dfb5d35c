"""The shifted-segment edit search's candidate union
(humid_tpu_torch.ops.neighbors.find_edit_pairs_shifted): each candidate
is kept by the first (segment, shift) join that finds it alone, with no
sort, as the benchmark's plain reference (``benchmark/reference/
humid_np.py::edit_pairs``) keeps it.

The union is held against a brute-force one over every pair of the table
(any join that finds the pair either way round), against the reference's
candidates where the words fit its 64-bit keys (up to 32 bases), and
against the sort-and-dedupe union the search took before.  Each runs
through numpy and, where it is built, through the port's host extension
(``humid_tpu_torch._cedit``).  Integer data: exact equality.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from humid_tpu_torch import words as W
from humid_tpu_torch.ops import edit as E
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import unique_words

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "humid_np_reference",
    os.path.join(ROOT, "benchmark", "reference", "humid_np.py"))
humid_np = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = humid_np  # its dataclasses look it up there
_spec.loader.exec_module(humid_np)

#: Word lengths of one, two and three 32-bit lanes.
CASES = [(length, m) for length in (18, 24, 33) for m in (1, 2, 3)]


def _edited(rng, n, length, m, pool=30):
    """[n, length] uint8 codes: pool words, a third untouched, a third
    with up to m substitutions, a third with a base deleted and one
    inserted at up to m places (indels inside the word)."""
    base = rng.integers(0, 4, (pool, length)).astype(np.uint8)
    codes = base[rng.integers(0, pool, n)].copy()
    for r in range(n):
        op = int(rng.integers(0, 3))
        for _ in range(int(rng.integers(1, m + 1)) if op else 0):
            i = int(rng.integers(0, length))
            if op == 1:
                codes[r, i] = rng.integers(0, 4)
            else:
                row = np.delete(codes[r], i)
                codes[r] = np.insert(row, int(rng.integers(0, length)),
                                     rng.integers(0, 4))
    return codes


def _table(length, m, n=320):
    rng = np.random.default_rng(1000 * length + m)
    uniq = unique_words(W.pack_words(_edited(rng, n, length, m)),
                        want_inverse=False)[0]
    return uniq, W.unpack_words(uniq, length)


def _brute_union(codes, m):
    """Every pair i < j that some (segment, shift) join finds, either
    word first: segment [lo, hi) of one equal to the other's bases d
    further on."""
    u, length = codes.shape
    i, j = np.triu_indices(u, 1)
    hit = np.zeros(len(i), bool)
    bounds = [length * s // (m + 1) for s in range(m + 2)]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for d in range(-m, m + 1):
            if lo + d < 0 or hi + d > length:
                continue
            seg, moved = codes[:, lo:hi], codes[:, lo + d:hi + d]
            hit |= (seg[i] == moved[j]).all(axis=1)
            hit |= (seg[j] == moved[i]).all(axis=1)
    return set(zip(i[hit].tolist(), j[hit].tolist()))


def _keys(codes):
    """The reference's words: 2 bits a base, the first base highest."""
    keys = np.zeros(len(codes), np.uint64)
    for c in range(codes.shape[1]):
        keys = (keys << np.uint64(2)) | codes[:, c].astype(np.uint64)
    return keys


def _reference_candidates(codes, m, monkeypatch):
    """The reference's distinct candidates as pairs (its DP made to pass
    every one) and its count of them."""
    with monkeypatch.context() as mp:
        mp.setattr(humid_np, "banded_levenshtein",
                   lambda a, b, m: np.zeros(a.shape[1], np.uint8))
        a, b, count = humid_np.edit_pairs(_keys(codes), codes.shape[1], m)
    return set(zip(a.tolist(), b.tolist())), count


def _impls():
    """numpy always; the host extension where it is built."""
    return ["numpy"] + (["native"] if N._first_join_native is not None
                        else [])


def _use(monkeypatch, impl):
    if impl == "numpy":
        monkeypatch.setattr(N, "_first_join_native", None)
        monkeypatch.setattr(N, "_merge_join_native", None)


def _candidates(uniq, length, m, monkeypatch, shard=None):
    """The search's distinct candidates, sorted (its DP made to keep
    every one), and its info."""
    info = {}
    with monkeypatch.context() as mp:
        mp.setattr(E, "edit_pairs_verify",
                   lambda packed, a, b, *args, **kw: (a, b))
        a, b = N.find_edit_pairs_shifted(uniq, m, word_length=length,
                                         device="cpu", info=info,
                                         shard=shard)
    return a, b, info


def _join(ka, oa, kb, ob, self_join):
    """One join's pairs, into buffers of the size its run lengths give."""
    need = N._join_size(ka[oa], kb[ob], self_join)
    a, b = np.empty(need, np.int64), np.empty(need, np.int64)
    n = N._merge_join_into(ka, oa, kb, ob, ka[oa], kb[ob], self_join, a, b,
                           "test")
    return a[:n], b[:n]


def _parent(uniq, length, m):
    """The search as it was before the first-join union: every join's
    output concatenated, sorted and deduplicated, then verified."""
    parts = [_join(ka, oa, kb, ob, d == 0)
             for _, d, ka, oa, kb, ob in N.shifted_joins(uniq, m, length)]
    a, b = N._dedupe_pairs(np.concatenate([p[0] for p in parts]),
                           np.concatenate([p[1] for p in parts]))
    return E.edit_pairs_verify(uniq, a, b, m, length, device="cpu")


@pytest.mark.parametrize("length,m", CASES)
def test_first_join_union_equals_reference(length, m, monkeypatch):
    """The union as a pair set: the brute-force one and, up to 32 bases,
    the reference's candidates; its count is the reference's."""
    uniq, codes = _table(length, m)
    want = _brute_union(codes, m)
    if length <= 32:
        ref, count = _reference_candidates(codes, m, monkeypatch)
        assert ref == want and count == len(want)
    for impl in _impls():
        with monkeypatch.context() as mp:
            _use(mp, impl)
            a, b, info = _candidates(uniq, length, m, mp)
        got = list(zip(a.tolist(), b.tolist()))
        assert len(got) == len(set(got)) == info["distinct_candidates"]
        assert set(got) == want, impl
        assert (info["candidates"] - info["first_join_dropped"]
                == info["distinct_candidates"])
        # From m = 2 on, words one substitution apart share m segments.
        assert info["first_join_dropped"] > 0 or m == 1


@pytest.mark.parametrize("length,m", CASES)
def test_search_output_equals_the_parent(length, m, monkeypatch):
    """The kept pairs, in order and dtype, are those of the sort and
    dedupe the search took before, and the reference's."""
    uniq, codes = _table(length, m)
    want = _parent(uniq, length, m)
    assert len(want[0]) > 0
    for impl in _impls():
        with monkeypatch.context() as mp:
            _use(mp, impl)
            info = {}
            got = N.find_edit_pairs_shifted(uniq, m, word_length=length,
                                            device="cpu", info=info)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == np.int64 and got[1].dtype == np.int64
        assert info["edit_pairs"] == len(want[0])
    if length <= 32:
        ra, rb, _ = humid_np.edit_pairs(_keys(codes), length, m)
        assert set(zip(ra.tolist(), rb.tolist())) == set(
            zip(want[0].tolist(), want[1].tolist()))


@pytest.mark.parametrize("self_join", [False, True], ids=["cross", "self"])
def test_join_emits_a_pair_met_both_ways_once(self_join, monkeypatch):
    """Rows 0 and 1 meet in both orientations of a cross join (ka[0] ==
    kb[1] and ka[1] == kb[0]), row 2 meets row 3 one way: each pair comes
    out once; a self join emits its i < j pairs once."""
    ka = np.array([5, 7, 5, 5] if self_join else [5, 7, 9, 4], np.uint64)
    kb = ka if self_join else np.array([7, 5, 1, 9], np.uint64)
    oa = np.argsort(ka, kind="stable")
    ob = oa if self_join else np.argsort(kb, kind="stable")
    want = [(0, 2), (0, 3), (2, 3)] if self_join else [(0, 1), (2, 3)]
    for impl in _impls():
        with monkeypatch.context() as mp:
            _use(mp, impl)
            a, b = _join(ka, oa, kb, ob, self_join)
        assert sorted(zip(a.tolist(), b.tolist())) == want, impl


def test_native_join_matches_numpy_on_pairs_met_both_ways():
    """The port's native cross join and its numpy twin emit the same
    pairs, each once, where many pairs meet in both orientations (few
    key values, and B's keys those of A in another order)."""
    if N._merge_join_native is None:
        pytest.skip("humid_tpu_torch._cedit is not built")
    rng = np.random.default_rng(17)
    ka = rng.integers(0, 5, 400).astype(np.uint64)
    kb = ka[rng.permutation(400)]
    oa, ob = np.argsort(ka, kind="stable"), np.argsort(kb, kind="stable")
    native = _join(ka, oa, kb, ob, False)
    plain = N._merge_join_numpy(ka, oa, kb, ob, False)
    got = list(zip(native[0].tolist(), native[1].tolist()))
    assert len(got) == len(set(got))
    assert sorted(got) == sorted(zip(plain[0].tolist(), plain[1].tolist()))
    assert len(got) < N._join_size(ka[oa], kb[ob], False)


@pytest.mark.parametrize("n_parts", [2, 3])
def test_sharded_parts_union_equals_the_whole(n_parts, monkeypatch):
    """Each distinct candidate comes from one part alone, and the parts'
    union is the whole search's."""
    uniq, _ = _table(24, 2)
    for impl in _impls():
        with monkeypatch.context() as mp:
            _use(mp, impl)
            wa, wb, whole = _candidates(uniq, 24, 2, mp)
            seen, distinct = [], 0
            for p in range(n_parts):
                a, b, info = _candidates(uniq, 24, 2, mp, shard=(p, n_parts))
                seen += list(zip(a.tolist(), b.tolist()))
                distinct += info["distinct_candidates"]
        assert len(seen) == len(set(seen)) == distinct
        assert set(seen) == set(zip(wa.tolist(), wb.tolist()))
        assert distinct == whole["distinct_candidates"]


def test_first_join_drops_what_an_earlier_join_found(monkeypatch):
    """The union alone, through numpy and the host extension: a pair of
    join p goes where an earlier join's columns match either way round,
    and the last survivors fill the places of those that went."""
    table = np.array([[1, 2, 3], [2, 1, 3], [1, 9, 9], [7, 7, 3]],
                     np.uint64)
    keys = [table[:, c].copy() for c in range(3)]
    # Join 0 on columns (0, 1) finds (0, 1); join 1 on (2, 2) finds the
    # pairs whose column 2 agrees, (0, 1) and (1, 3); join 2 keeps (0, 2)
    # and (2, 3) and loses (1, 3) to join 1.
    cols = [(0, 1), (2, 2), (1, 0)]
    starts = [0, 1, 3, 6]
    for impl in _impls():
        a = np.array([0, 0, 1, 0, 1, 2], np.int64)
        b = np.array([1, 1, 3, 2, 3, 3], np.int64)
        with monkeypatch.context() as mp:
            _use(mp, impl)
            ua, ub = N._first_join_union(keys, cols, starts, a, b)
        # Places 1 and 4 went; the survivor at 5 moved to 1.
        assert list(zip(ua.tolist(), ub.tolist())) == [
            (0, 1), (2, 3), (1, 3), (0, 2)], impl
