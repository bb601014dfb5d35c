"""The port's neighbour search (humid_tpu_torch.ops.neighbors) against
the JAX package's find_neighbor_pairs.

Inputs are made with numpy from fixed seeds and fed to both packages.
Pair lists are integer data, so every comparison is exact equality.  The
JAX side runs its host ``runs`` engine (what it picks off-TPU for large
tables) or its XLA dense tile scan; the port runs its dense and bucketed
tile sweeps, on the CPU through the sweep's plain version, and ``auto``,
which on the CPU device is the host ``runs`` engine too.
"""

import numpy as np
import pytest

from humid_tpu.ops import neighbors as JN
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import cuda_hamming as K
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import unique_words


def _table(rng, length, n_pool, n_reads, max_subst):
    """Ascending unique packed table from a pool with substitutions."""
    pool = rng.integers(0, 4, (n_pool, length), dtype=np.uint8)
    codes = pool[rng.integers(0, n_pool, n_reads)]
    for _ in range(max_subst):
        hit = rng.random(n_reads) < 0.5
        codes[np.flatnonzero(hit), rng.integers(0, length, int(hit.sum()))] \
            = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
    uniq, _, _, _ = unique_words(W.pack_words(codes), want_inverse=False)
    return uniq


def _assert_pairs(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64


@pytest.mark.parametrize("length", [16, 24, 33])
@pytest.mark.parametrize("m", [0, 1, 2, 3])
def test_engines_match_reference(m, length):
    rng = np.random.default_rng(10 * m + length)
    uniq = _table(rng, length, 250, 1400, m + 1)
    assert len(uniq) > 512  # above runs_threshold: auto -> the router
    want = JN.find_neighbor_pairs(uniq, m, word_length=length,
                                  strategy="runs")
    if m:
        assert len(want[0]) > 0
    for strategy in ("dense", "bucketed", "auto"):
        _assert_pairs(N.find_neighbor_pairs(
            uniq, m, word_length=length, strategy=strategy, tile=512,
            runs_threshold=512, device="cpu"), want)


@pytest.mark.parametrize("length", [16, 33])
def test_small_table_matches_dense_reference(length):
    """Below runs_threshold both packages take their dense engine."""
    rng = np.random.default_rng(length)
    uniq = _table(rng, length, 40, 500, 2)
    want = JN.find_neighbor_pairs(uniq, 2, word_length=length,
                                  strategy="dense", impl="xor")
    _assert_pairs(N.find_neighbor_pairs(uniq, 2, word_length=length,
                                        device="cpu"), want)


def test_degenerate_giant_run():
    """Every word shares its first pigeonhole segment (substitutions only
    in positions 12-23): one run spans every tile, so the bucketed list
    falls back to the dense tile grid.  ``auto`` (on the CPU device the
    host runs engine) gives the same pairs."""
    rng = np.random.default_rng(5)
    tpl = rng.integers(0, 4, 24, dtype=np.uint8)
    codes = np.tile(tpl, (3000, 1))
    for _ in range(3):
        codes[np.arange(3000), 12 + rng.integers(0, 12, 3000)] = (
            rng.integers(0, 4, 3000, dtype=np.uint8))
    uniq, _, _, _ = unique_words(W.pack_words(codes), want_inverse=False)
    assert len(uniq) > 1024
    rows, tile_pairs, b, u_pad, _ = N.bucketed_inputs(uniq, 1, 24, 256)
    t = u_pad // b
    assert len(tile_pairs) >= t * (t + 1) // 2  # dense grid in partition 0
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    for strategy in ("bucketed", "auto"):
        _assert_pairs(N.find_neighbor_pairs(
            uniq, 1, word_length=24, tile=256, strategy=strategy,
            runs_threshold=1024, device="cpu"), want)


def test_forced_capacity_retry(monkeypatch):
    """A tiny first pair buffer forces the relaunch-with-exact-capacity
    path (and chunk splitting) under the bucketed engine."""
    rng = np.random.default_rng(9)
    uniq = _table(rng, 24, 250, 1400, 2)
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    monkeypatch.setattr(K, "CAP_START", 8)
    monkeypatch.setattr(K, "MAX_CAP", 64)
    monkeypatch.setattr(K, "CHUNK_PAIRS", 3)
    _assert_pairs(N.find_neighbor_pairs(uniq, 1, word_length=24, tile=256,
                                        strategy="bucketed", device="cpu"),
                  want)


@pytest.mark.parametrize("u,m,length,want", [
    (3000, 1, 24, "runs"), (3000, 0, 24, "dense"),
    (2048, 1, 24, "dense"), (3000, 1, None, "dense")])
def test_choose_engine(u, m, length, want):
    """Above the size gate the router answers; on the CPU device that is
    the host runs engine."""
    assert N.choose_engine(u, m, length, device="cpu") == want


@pytest.mark.parametrize("n_seg", [2, 4])
@pytest.mark.parametrize("length", [16, 24, 33])
def test_segment_run_ids(length, n_seg):
    rng = np.random.default_rng(length + n_seg)
    uniq = _table(rng, length, 50, 300, 1)
    for got, want in zip(N._segment_run_ids(uniq, length, n_seg),
                         JN._segment_run_ids(uniq, length, n_seg)):
        np.testing.assert_array_equal(got, want)


def test_dedupe_pairs_and_csr():
    rng = np.random.default_rng(12)
    a = rng.integers(0, 300, 2000)
    b = rng.integers(0, 300, 2000)
    a, b = np.minimum(a, b), np.maximum(a, b)
    keep = a < b
    a, b = a[keep], b[keep]
    _assert_pairs(N._dedupe_pairs(a, b), JN._dedupe_pairs(a, b))
    da, db = N._dedupe_pairs(a, b)
    for got, want in zip(N.pairs_to_csr(da, db, 300),
                         JN.pairs_to_csr(da, db, 300)):
        np.testing.assert_array_equal(got, want)
