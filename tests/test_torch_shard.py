"""Host-sharded neighbour search (``find_neighbor_pairs(shard=(p, P))``):
the port against the JAX package, part by part.

For every engine that honours a shard and P in {2, 3}: the deduplicated
union of the parts equals the unsharded pair list, and each part equals
the JAX package's part for the same shard (the same salted run ownership,
the same tile-pair stripes).  The edit engines are held against the JAX
package's ``strategy="dense"``: its shifted-segment search needs its
native merge join (humid_tpu/ops/neighbors.py:1389-1392).  Pair lists are
integer data: exact equality.
"""

import numpy as np
import pytest
import torch

from humid_tpu.ops import neighbors as JN
from humid_tpu.ops import runs_device as JRD
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import runs_device as RD
from humid_tpu_torch.ops import unique_words


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(seed, n=1500, pool=40, length=24, indels=False):
    """Sorted unique words of a near-duplicate population: ``pool``
    templates, 80% of the draws with one substitution (pool 40 gives runs
    longer than 12 rows in both partitions at m = 1, under the giant-run
    fallback's line), with ``indels`` also shifted copies."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, (pool, length + 1), dtype=np.uint8)
    codes = base[rng.integers(0, pool, n)].copy()
    flip = rng.random(n) < 0.8
    codes[np.flatnonzero(flip), rng.integers(0, length, int(flip.sum()))] = (
        rng.integers(0, 4, int(flip.sum()), dtype=np.uint8))
    if indels:
        shift = rng.random(n) < 0.3
        codes[shift, :length] = codes[shift, 1:]
    return unique_words(W.pack_words(codes[:, :length]), want_inverse=False,
                        device="cpu")[0]


@pytest.fixture(scope="module")
def table():
    return _table(3)


def _union(parts):
    a = np.concatenate([p[0] for p in parts])
    b = np.concatenate([p[1] for p in parts])
    return N._dedupe_pairs(a, b) if len(a) else (a, b)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _port(uniq, m, strategy, shard=None, **kw):
    return N.find_neighbor_pairs(uniq, m, word_length=24, strategy=strategy,
                                 device="cpu", shard=shard, **kw)


def _jax(uniq, m, strategy, shard=None, **kw):
    return JN.find_neighbor_pairs(uniq, m, word_length=24, strategy=strategy,
                                  shard=shard, **kw)


@pytest.mark.parametrize("n_parts", [2, 3])
@pytest.mark.parametrize("strategy,kw", [
    ("runs", {}), ("runs_device", {}), ("bucketed", {"tile": 256}),
    ("dense", {"tile": 256})])
def test_parts_match_reference_and_tile_the_pair_set(table, strategy, kw,
                                                     n_parts):
    full = _port(table, 1, strategy, **kw)
    _same(full, _jax(table, 1, strategy, **kw))
    parts = []
    for p in range(n_parts):
        info = {}
        got = _port(table, 1, strategy, (p, n_parts), info=info, **kw)
        _same(got, _jax(table, 1, strategy, (p, n_parts), **kw))
        assert info["shard"] == (p, n_parts)
        parts.append(got)
    _same(_union(parts), full)
    assert all(len(x[0]) < len(full[0]) for x in parts)


@pytest.mark.parametrize("n_parts", [2, 3])
@pytest.mark.parametrize("engine", ["runs", "runs_device"])
def test_owned_big_runs_go_through_the_tile_sweep(table, engine, n_parts,
                                                  monkeypatch):
    """run_cap = 12 sends the runs past it to _big_run_pairs (K1's plain
    version here, with its run-id mask); each part sweeps only its owned
    big runs, and equals the JAX part."""
    from humid_tpu_torch.ops import cuda_hamming as K

    swept = []
    real = K.hamming_tile_pairs
    monkeypatch.setattr(N, "hamming_tile_pairs", lambda *a, **k: (
        swept.append(k.get("ids") is not None) or real(*a, **k)))
    port = (N.find_neighbor_pairs_runs if engine == "runs"
            else RD.runs_device_pairs)
    ref = (JN.find_neighbor_pairs_runs if engine == "runs"
           else JRD.runs_device_pairs)
    full = port(table, 1, word_length=24, run_cap=12, tile=256,
                device="cpu")
    parts = []
    for p in range(n_parts):
        info = {}
        got = port(table, 1, word_length=24, run_cap=12, tile=256,
                   device="cpu", shard=(p, n_parts), info=info)
        assert info["dense_fallbacks"] == 0
        _same(got, ref(table, 1, word_length=24, run_cap=12, tile=256,
                       shard=(p, n_parts)))
        parts.append(got)
    _same(_union(parts), full)
    assert swept and all(swept)


def test_giant_runs_fall_back_together(monkeypatch):
    """Runs covering more rows than the table send every part to the dense
    stripes (the decision uses the row count before ownership)."""
    uniq = _table(5, pool=20)
    full = _port(uniq, 1, "runs")
    parts = []
    for p in range(2):
        info = {}
        got = N.find_neighbor_pairs_runs(uniq, 1, word_length=24, run_cap=12,
                                         tile=256, device="cpu",
                                         shard=(p, 2), info=info)
        assert info["dense_fallbacks"] == 1
        _same(got, JN.find_neighbor_pairs_runs(uniq, 1, word_length=24,
                                               run_cap=12, tile=256,
                                               shard=(p, 2)))
        parts.append(got)
    _same(_union(parts), full)


@pytest.mark.parametrize("n_parts", [2, 3])
def test_m2_parts(n_parts):
    """Three partitions, pairs found under several of them: the parts
    still equal the reference's and tile the pair set."""
    uniq = _table(11, n=1200, pool=60)
    full = _port(uniq, 2, "runs")
    parts = [_port(uniq, 2, "runs", (p, n_parts)) for p in range(n_parts)]
    for p, got in enumerate(parts):
        _same(got, _jax(uniq, 2, "runs", (p, n_parts)))
    _same(_union(parts), full)


@pytest.fixture(scope="module")
def edit_table():
    return _table(13, n=1400, pool=60, indels=True)


@pytest.mark.parametrize("n_parts", [2, 3])
def test_edit_dense_parts_match_reference(edit_table, n_parts):
    want_full = JN.find_neighbor_pairs(edit_table, 2, metric="edit",
                                       word_length=24, strategy="dense")
    parts = []
    for p in range(n_parts):
        got = N.find_neighbor_pairs(edit_table, 2, metric="edit",
                                    word_length=24, strategy="dense",
                                    device="cpu", shard=(p, n_parts))
        _same(got, JN.find_neighbor_pairs(edit_table, 2, metric="edit",
                                          word_length=24, strategy="dense",
                                          shard=(p, n_parts)))
        parts.append(got)
    _same(_union(parts), want_full)


@pytest.mark.parametrize("n_parts", [2, 3])
def test_edit_shifted_parts_tile_the_pair_set(edit_table, n_parts):
    """The shifted-segment search under a shard (owned join keys, salt per
    (segment, shift)): the parts' union equals the JAX dense edit scan."""
    want = JN.find_neighbor_pairs(edit_table, 2, metric="edit",
                                  word_length=24, strategy="dense")
    parts, cands = [], []
    for p in range(n_parts):
        info = {}
        parts.append(N.find_neighbor_pairs(
            edit_table, 2, metric="edit", word_length=24, strategy="runs",
            device="cpu", shard=(p, n_parts), info=info))
        cands.append(info["candidates"])
    _same(_union(parts), want)
    whole = {}
    N.find_neighbor_pairs(edit_table, 2, metric="edit", word_length=24,
                          strategy="runs", device="cpu", info=whole)
    assert sum(cands) == whole["candidates"]


def test_edit_join_cap_is_checked_before_ownership(edit_table):
    """A cap that only the whole join exceeds raises on every part."""
    sizes = []
    for s, d, ka, oa, kb, ob in N.shifted_joins(edit_table, 2, 24):
        ks = ka[oa]
        sizes.append(N._join_size(ks, ks if d == 0 else kb[ob], d == 0))
    cap = max(sizes) - 1
    for p in range(3):
        with pytest.raises(N.JoinCapExceeded):
            N.find_neighbor_pairs(edit_table, 2, metric="edit",
                                  word_length=24, strategy="runs",
                                  device="cpu", shard=(p, 3), join_cap=cap)


def test_auto_under_a_shard_takes_host_runs(table, monkeypatch):
    """A bare auto under a shard ignores the router (each process's pick
    may differ) and keeps host runs above the size gate."""
    from humid_tpu_torch import _backend as B

    monkeypatch.setattr(B, "pick_neighbor_engine",
                        lambda dev, u, shardable_only=False: "bucketed")
    info = {}
    got = N.find_neighbor_pairs(table, 1, word_length=24, device="cpu",
                                runs_threshold=100, shard=(0, 2), info=info)
    assert info["strategy"] == "runs"
    _same(got, _jax(table, 1, "runs", (0, 2)))


def test_one_part_is_no_shard(table):
    info = {}
    _same(_port(table, 1, "runs", (0, 1), info=info), _port(table, 1, "runs"))
    assert "shard" not in info
