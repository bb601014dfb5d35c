"""The port's local-mesh neighbour search (humid_tpu_torch.parallel)
against the JAX package's (humid_tpu.parallel).

Inputs are made with numpy from fixed seeds and fed to both packages.  The
port runs on ``device="cpu"`` through the plain versions of its kernels,
with a mesh of d CPU shards; the JAX side runs as tests/test_parallel.py
runs it, on the 8-device virtual CPU mesh with the Pallas ring kernel in
interpret mode.  Pair lists are integer data: exact equality, tolerance 0.
"""

import numpy as np
import pytest
import torch

from humid_tpu import parallel as JP
from humid_tpu.ops import neighbors as JN
from humid_tpu_torch import parallel as P
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import cuda_hamming as K
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import unique_words
from humid_tpu_torch.parallel import cuda_ring as R


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tables here are tiny, and several test processes share the
    machine's cores: with a full thread pool in each, every small CPU op
    waits for threads that are not scheduled.  One thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(rng, n, length, pool=6):
    """The generator of tests/test_parallel.py."""
    base = rng.integers(0, 4, size=(pool, length)).astype(np.uint8)
    codes = base[rng.integers(0, pool, n)].copy()
    muts = rng.integers(0, length, n)
    flip = rng.random(n) < 0.7
    codes[np.arange(n)[flip], muts[flip]] = rng.integers(0, 4, flip.sum())
    return codes


def _uniq(codes):
    return unique_words(W.pack_words(codes), want_inverse=False)[0]


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64


def _cpu_mesh(d):
    return P.data_mesh(d, "cpu")


@pytest.mark.parametrize("n_dev", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("m", [1, 2])
def test_ring_matches_pallas_ring(n_dev, m):
    rng = np.random.default_rng(700 + 10 * n_dev + m)
    uniq = _uniq(_dataset(rng, 800, 24, pool=80))
    want = JP.sharded_neighbor_pairs_pallas_ring(
        uniq, m, word_length=24, mesh=JP.data_mesh(n_dev), cap_row=4)
    assert len(want[0]) > 0
    _same(P.sharded_neighbor_pairs_ring(
        uniq, m, word_length=24, mesh=_cpu_mesh(n_dev), cap_row=4), want)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("m", [1, 2])
def test_sharded_matches_reference(n_dev, m):
    rng = np.random.default_rng(100 + 10 * n_dev + m)
    uniq = _uniq(_dataset(rng, 600, 20))
    want = JP.sharded_neighbor_pairs(uniq, m, mesh=JP.data_mesh(n_dev),
                                     cap_row=4)
    _same(P.sharded_neighbor_pairs(uniq, m, mesh=_cpu_mesh(n_dev),
                                   cap_row=4), want)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("m", [1, 2])
def test_sharded_bucketed_matches_reference(n_dev, m):
    rng = np.random.default_rng(300 + 10 * n_dev + m)
    uniq = _uniq(_dataset(rng, 700, 20))
    want = JP.sharded_neighbor_pairs_bucketed(
        uniq, m, word_length=20, mesh=JP.data_mesh(n_dev), cap_row=4)
    assert len(want[0]) > 0
    _same(P.sharded_neighbor_pairs_bucketed(
        uniq, m, word_length=20, mesh=_cpu_mesh(n_dev)), want)


def test_sharded_bucketed_giant_runs_fall_back_to_ring(monkeypatch):
    """One template with scattered substitutions: giant equal-key runs in
    several partitions send the bucketed mesh search to the dense ring,
    as in the reference."""
    rng = np.random.default_rng(55)
    base = rng.integers(0, 4, 24).astype(np.uint8)
    codes = np.tile(base, (700, 1))
    codes[np.arange(700), rng.integers(0, 24, 700)] = rng.integers(0, 4, 700)
    uniq = _uniq(codes)
    want = JP.sharded_neighbor_pairs_bucketed(
        uniq, 2, word_length=24, mesh=JP.data_mesh(4), cap_row=8, run_cap=16)
    with pytest.raises(P.neighbors.GiantRuns):
        P.neighbors.bucketed_shard_inputs(uniq, 2, 24, 4, run_cap=16)
    swept = []
    monkeypatch.setattr(
        P.neighbors, "sweep",
        lambda *a, **k: swept.append(1))  # the tile sweep must not run
    _same(P.sharded_neighbor_pairs_bucketed(
        uniq, 2, word_length=24, mesh=_cpu_mesh(4), run_cap=16), want)
    assert not swept


def test_sharded_bucketed_low_entropy_runs():
    """Few distinct segment keys -> runs that span several tiles."""
    rng = np.random.default_rng(9)
    uniq = _uniq(_dataset(rng, 600, 16, pool=3))
    want = JP.sharded_neighbor_pairs_bucketed(
        uniq, 2, word_length=16, mesh=JP.data_mesh(4), cap_row=2,
        cap_total=1 << 8)
    _same(P.sharded_neighbor_pairs_bucketed(
        uniq, 2, word_length=16, mesh=_cpu_mesh(4), tile=256), want)


@pytest.mark.parametrize("engine", ["ring", "bucketed"])
def test_no_matches(engine):
    codes = np.array([[0, 1, 2, 3] * 6, [3, 2, 1, 0] * 6], np.uint8)
    fn = {"ring": P.sharded_neighbor_pairs_ring,
          "bucketed": P.sharded_neighbor_pairs_bucketed}[engine]
    a, b = fn(_uniq(codes), 1, word_length=24, mesh=_cpu_mesh(2))
    assert len(a) == 0 and len(b) == 0
    assert a.dtype == np.int64 and b.dtype == np.int64


@pytest.mark.parametrize("strategy", ["ring", "sharded", "sharded_bucketed"])
def test_strategy_dispatch(strategy):
    rng = np.random.default_rng(77)
    uniq = _uniq(_dataset(rng, 800, 24))
    jax_strategy = "pallas_ring" if strategy == "ring" else strategy
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24,
                                  strategy=jax_strategy, runs_threshold=16)
    info = {}
    got = N.find_neighbor_pairs(uniq, 1, word_length=24, strategy=strategy,
                                runs_threshold=16, device="cpu",
                                mesh=_cpu_mesh(3), info=info)
    _same(got, want)
    assert info == {"metric": "hamming", "strategy": strategy,
                    "shards": 3, "ring_fallbacks": 0}


def test_sharded_below_threshold_takes_ring(monkeypatch):
    rng = np.random.default_rng(78)
    uniq = _uniq(_dataset(rng, 300, 24))
    monkeypatch.setattr(P, "sharded_neighbor_pairs_bucketed", None)
    want = N.find_neighbor_pairs(uniq, 1, word_length=24, strategy="dense",
                                 device="cpu")
    _same(N.find_neighbor_pairs(uniq, 1, word_length=24, strategy="sharded",
                                device="cpu", mesh=_cpu_mesh(2)), want)


def _edit_table(rng, n, length, m, pool=25):
    """Pool words with substitutions and shifts (indels at both ends)."""
    base = rng.integers(0, 4, (pool, length)).astype(np.uint8)
    codes = base[rng.integers(0, pool, n)].copy()
    for r in range(n):
        op = int(rng.integers(0, 3))
        if op == 1:
            codes[r, int(rng.integers(0, length))] = rng.integers(0, 4)
        elif op == 2:
            d = int(rng.integers(1, m + 1))
            codes[r, d:] = codes[r, :length - d].copy()
            codes[r, :d] = rng.integers(0, 4, d)
    return _uniq(codes)


@pytest.fixture(scope="module")
def edit_case():
    """A table with its dense edit pairs by the JAX package and by the
    port (which must agree)."""
    uniq = _edit_table(np.random.default_rng(61), 400, 24, 1)
    want = JN.find_neighbor_pairs(uniq, 1, metric="edit", word_length=24,
                                  strategy="dense")
    assert len(want[0]) > 0
    _same(N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=24,
                                strategy="dense", device="cpu"), want)
    return uniq, want


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_edit_ring_matches_dense(n_dev, edit_case):
    uniq, want = edit_case
    _same(P.sharded_neighbor_pairs(uniq, 1, metric="edit", word_length=24,
                                   mesh=_cpu_mesh(n_dev)), want)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_edit_ring_matches_reference_ring(n_dev):
    uniq = _edit_table(np.random.default_rng(62), 300, 18, 1)
    want = JP.sharded_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                                     mesh=JP.data_mesh(n_dev), cap_row=4)
    assert len(want[0]) > 0
    _same(P.sharded_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                                   mesh=_cpu_mesh(n_dev)), want)


def test_edit_mesh_searches_on_three_lane_words():
    """L = 33 (three lanes, the last one half empty), m = 2: the ring on
    3 shards and the shifted mesh search on 2."""
    uniq = _edit_table(np.random.default_rng(65), 300, 33, 2)
    want = JN.find_neighbor_pairs(uniq, 2, metric="edit", word_length=33,
                                  strategy="dense")
    assert len(want[0]) > 0
    _same(P.sharded_neighbor_pairs(uniq, 2, metric="edit", word_length=33,
                                   mesh=_cpu_mesh(3)), want)
    _same(P.sharded_edit_pairs_shifted(uniq, 2, word_length=33,
                                       mesh=_cpu_mesh(2)), want)


def test_edit_ring_with_several_tiles_per_block():
    """Blocks of two tiles, the last one ragged: every step scans a grid
    of tile pairs and masks the padding by index."""
    uniq = _edit_table(np.random.default_rng(63), 1000, 18, 1, pool=300)
    assert len(uniq) > 2 * 256
    want = N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                                 strategy="dense", device="cpu")
    assert len(want[0]) > 0
    _same(P.sharded_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                                   mesh=_cpu_mesh(2), tile=256), want)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_edit_pairs_shifted_matches_dense(n_dev, edit_case):
    uniq, want = edit_case
    info = {}
    _same(P.sharded_edit_pairs_shifted(uniq, 1, word_length=24,
                                       mesh=_cpu_mesh(n_dev), info=info),
          want)
    assert info["candidates"] >= len(want[0])


def test_sharded_edit_pairs_shifted_groups_that_span_tiles():
    """One template with substitutions in its tail: most words share
    their first segment, so that group spans several 256-row tiles (a
    self-join group, scanned by its upper-triangle tile pairs)."""
    rng = np.random.default_rng(64)
    codes = np.tile(rng.integers(0, 4, 16).astype(np.uint8), (1500, 1))
    for _ in range(3):
        codes[np.arange(1500), 6 + rng.integers(0, 10, 1500)] = (
            rng.integers(0, 4, 1500))
    uniq = _uniq(codes)
    assert len(uniq) > 600
    want = N.find_neighbor_pairs(uniq, 2, metric="edit", word_length=16,
                                 strategy="dense", device="cpu")
    prep = P.neighbors.shifted_shard_inputs(uniq, 2, 16, 3, tile=256)
    assert prep["tile"] == 256
    assert max(len(sh["tile_pairs"]) for sh in prep["shards"]) > 4
    for sh in prep["shards"]:  # padding ids never meet across the sides
        assert not set(sh["ids_a"][sh["valid_a"]:]) & set(
            sh["ids_b"][sh["valid_b"]:])
    _same(P.sharded_edit_pairs_shifted(uniq, 2, word_length=16,
                                       mesh=_cpu_mesh(3), tile=256), want)


def test_sharded_edit_word_meets_itself_under_a_shifted_key():
    """A periodic word equals itself one base further on: the shifted
    joins pair it with itself, and that pair must not come out."""
    codes = np.zeros((4, 16), np.uint8)
    codes[1, 15] = 1
    codes[2, 0] = 2
    codes[3] = 3
    uniq = _uniq(codes)
    want = N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=16,
                                 strategy="dense", device="cpu")
    assert len(want[0]) > 0
    got = P.sharded_edit_pairs_shifted(uniq, 1, word_length=16,
                                       mesh=_cpu_mesh(2))
    _same(got, want)
    assert (got[0] < got[1]).all()
    _same(N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=16,
                                strategy="runs", device="cpu"), want)


def test_sharded_edit_dispatch(edit_case, monkeypatch):
    """``sharded`` + edit: the shifted mesh search above runs_threshold,
    the dense edit ring below it."""
    uniq, want = edit_case
    info = {}
    _same(N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=24,
                                strategy="sharded", runs_threshold=16,
                                device="cpu", mesh=_cpu_mesh(3), info=info),
          want)
    assert info["metric"] == "edit" and info["strategy"] == "sharded"
    assert info["shards"] == 3 and info["join_cap_fallbacks"] == 0
    assert info["candidates"] > 0
    monkeypatch.setattr(P, "sharded_edit_pairs_shifted", None)
    info = {}
    _same(N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=24,
                                strategy="sharded", device="cpu",
                                mesh=_cpu_mesh(2), info=info), want)
    assert info == {"metric": "edit", "strategy": "sharded", "shards": 2,
                    "ring_fallbacks": 0}


def test_sharded_edit_degenerate_table_falls_back_to_ring(monkeypatch):
    """Every word shares its first segment: the shifted mesh search
    exceeds join_cap and the search completes through the dense ring."""
    rng = np.random.default_rng(42)
    codes = np.empty((600, 18), np.uint8)
    codes[:, :9] = rng.integers(0, 4, 9).astype(np.uint8)
    codes[:, 9:] = rng.integers(0, 4, (600, 9))
    uniq = _uniq(codes)
    want = JN.find_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                                  strategy="dense")
    with pytest.raises(N.JoinCapExceeded, match="join_cap"):
        P.sharded_edit_pairs_shifted(uniq, 1, word_length=18, join_cap=64,
                                     mesh=_cpu_mesh(2))
    ring_calls = []
    ring = P.sharded_neighbor_pairs
    monkeypatch.setattr(P, "sharded_neighbor_pairs",
                        lambda *a, **k: ring_calls.append(k) or ring(*a, **k))
    info = {}
    _same(N.find_neighbor_pairs(uniq, 1, metric="edit", word_length=18,
                                strategy="sharded", runs_threshold=256,
                                join_cap=64, device="cpu",
                                mesh=_cpu_mesh(2), info=info), want)
    assert len(ring_calls) == 1 and ring_calls[0]["metric"] == "edit"
    assert info["join_cap_fallbacks"] == 1


def test_sharded_edit_rejects_bad_requests():
    uniq = _uniq(_dataset(np.random.default_rng(1), 50, 16))
    with pytest.raises(ValueError, match="word_length"):
        P.sharded_neighbor_pairs(uniq, 1, metric="edit", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="unknown metric"):
        P.sharded_neighbor_pairs(uniq, 1, metric="jaccard", word_length=16,
                                 mesh=_cpu_mesh(2))
    a, b = P.sharded_neighbor_pairs(uniq[:1], 1, metric="edit",
                                    word_length=16, mesh=_cpu_mesh(2))
    assert len(a) == 0 and a.dtype == np.int64
    a, b = P.sharded_edit_pairs_shifted(uniq, 0, word_length=16,
                                        mesh=_cpu_mesh(2))
    assert len(a) == 0 and b.dtype == np.int64


def test_environment_variables(monkeypatch):
    """HUMID_TPU_TORCH_STRATEGY replaces "auto" only;
    HUMID_TPU_TORCH_SHARDS sizes the default mesh."""
    rng = np.random.default_rng(79)
    uniq = _uniq(_dataset(rng, 500, 24))
    want = N.find_neighbor_pairs(uniq, 1, word_length=24, strategy="dense",
                                 device="cpu")
    monkeypatch.setenv("HUMID_TPU_TORCH_STRATEGY", "ring")
    monkeypatch.setenv("HUMID_TPU_TORCH_SHARDS", "5")
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE", "cpu")
    assert P.data_mesh() == (torch.device("cpu"),) * 5
    info = {}
    _same(N.find_neighbor_pairs(uniq, 1, word_length=24, info=info), want)
    assert info == {"metric": "hamming", "strategy": "ring", "shards": 5,
                    "ring_fallbacks": 0}
    info = {}
    N.find_neighbor_pairs(uniq, 1, word_length=24, strategy="dense",
                          info=info)
    assert info == {"metric": "hamming", "strategy": "dense"}


def test_data_mesh():
    assert P.data_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert P.data_mesh(device="cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        P.data_mesh(0, "cpu")
    x = np.arange(10).reshape(5, 2)
    padded = P.pad_to_shards(x, 3, multiple=1)
    assert padded.shape == (6, 2) and (padded[5] == 0).all()
    assert P.pad_to_shards(x, 5, multiple=1) is x


def test_block_cap_raises_and_forced_ring_falls_back():
    rng = np.random.default_rng(91)
    uniq = _uniq(rng.integers(0, 4, size=(3000, 24)).astype(np.uint8))
    with pytest.raises(P.RingLimitExceeded, match="block_cap"):
        P.sharded_neighbor_pairs_ring(uniq, 1, word_length=24,
                                      mesh=_cpu_mesh(1), block_cap=1024)
    assert issubclass(P.RingLimitExceeded, ValueError)
    assert P.ring_fits(1 << 22, 1) and not P.ring_fits((1 << 22) + 1, 1)
    assert P.ring_fits((1 << 23), 2)
    assert P.ring_fits(2048, 2, 1024) and not P.ring_fits(2049, 2, 1024)


def test_forced_ring_above_cap_goes_dense(monkeypatch):
    rng = np.random.default_rng(92)
    uniq = _uniq(_dataset(rng, 600, 24, pool=60))
    want = N.find_neighbor_pairs(uniq, 1, word_length=24, strategy="dense",
                                 device="cpu")
    monkeypatch.setattr(R, "RING_MAX_BLOCK", 64)
    info = {}
    _same(N.find_neighbor_pairs(uniq, 1, word_length=24, strategy="ring",
                                device="cpu", mesh=_cpu_mesh(2), info=info),
          want)
    assert info == {"metric": "hamming", "strategy": "ring", "shards": 2,
                    "ring_fallbacks": 1}


def test_one_unique_word_reports_its_own_decision():
    """A table with one word returns no pair and still says what it was
    asked to run, whatever an earlier call ran."""
    rng = np.random.default_rng(93)
    uniq = _uniq(_dataset(rng, 300, 24))
    N.find_neighbor_pairs(uniq, 1, word_length=24, strategy="ring",
                          device="cpu", mesh=_cpu_mesh(3), info={})
    info = {}
    a, b = N.find_neighbor_pairs(uniq[:1], 1, word_length=24, device="cpu",
                                 info=info)
    assert len(a) == 0 and len(b) == 0
    assert info == {"metric": "hamming", "strategy": "dense"}


@pytest.mark.parametrize("d", range(1, 10))
def test_ring_schedule_covers_every_block_pair_once(d):
    sched = P.ring_schedule(d)
    assert len(sched) == d * (d // 2 + 1)
    assert [s for _, s, _, _, _ in sched] == sorted(s for _, s, _, _, _
                                                    in sched)  # step-major
    seen = {}
    for me, s, q, upper_only, emits in sched:
        assert q == (me + s) % d and upper_only == (s == 0)
        if emits:
            key = (min(me, q), max(me, q))
            seen[key] = seen.get(key, 0) + 1
    assert seen == {(i, j): 1 for i in range(d) for j in range(i, d)}


@pytest.mark.parametrize("dtype,shape", [(torch.int32, (5, 2)),
                                         (torch.int32, (4, 33))],
                         ids=["lanes", "codes"])
def test_ring_slots_carry_blocks_around_the_ring(dtype, shape):
    """ring_slots is the part both rings share: after the schedule's
    forwards, slot s of shard ``me`` holds block (me + s) % d, whatever
    the block's shape (lane blocks of the Hamming ring, code blocks of
    the edit ring)."""
    d, steps = 4, 3
    cpu = torch.device("cpu")
    blocks = [torch.full(shape, 10 + me, dtype=dtype) for me in range(d)]
    shards = [R.ring_slots(blk, steps, cpu) for blk in blocks]
    for me, s, q, _, _ in R.ring_schedule(d):
        if s + 1 < steps:
            shards[me].forward(shards[(me - 1) % d], s)
        with shards[me].computing(s):
            assert torch.equal(shards[me].slots[s], blocks[q])
    for sh in shards:
        sh.join()
        assert sh.slots.shape == (steps, *shape) and sh.compute is None


@pytest.mark.parametrize("u,d", [(601, 4), (7, 3), (3, 8), (2, 5)])
def test_ring_ragged_blocks(u, d):
    """u not a multiple of d, and fewer rows than shards."""
    rng = np.random.default_rng(u + d)
    uniq = _uniq(_dataset(rng, 3 * u, 24, pool=max(2, u // 6)))[:u]
    assert len(uniq) == u
    want = JN.find_neighbor_pairs(uniq, 2, word_length=24, strategy="dense",
                                  impl="xor")
    _same(P.sharded_neighbor_pairs_ring(uniq, 2, word_length=24,
                                        mesh=_cpu_mesh(d)), want)


def test_ring_capacity_rerun(monkeypatch):
    """A tiny first pair buffer forces the exact-capacity rerun of the
    shards that overflowed."""
    rng = np.random.default_rng(12)
    uniq = _uniq(_dataset(rng, 700, 24, pool=20))
    want = N.find_neighbor_pairs(uniq, 2, word_length=24, strategy="dense",
                                 device="cpu")
    assert len(want[0]) > 64
    monkeypatch.setattr(R, "CAP_START", 8)
    _same(P.sharded_neighbor_pairs_ring(uniq, 2, word_length=24,
                                        mesh=_cpu_mesh(3)), want)


@pytest.mark.parametrize("upper_only", [True, False])
def test_ring_block_pairs_plain_against_brute_force(upper_only):
    """One ring step against a numpy double loop, with u cutting the
    column block and padding rows that equal real words."""
    rng = np.random.default_rng(5)
    codes = _dataset(rng, 96, 20, pool=4)
    packed = W.pack_words(codes)
    rows, cols = packed[:48].copy(), packed[:48].copy() if upper_only \
        else packed[48:].copy()
    row_base, col_base = (48, 48) if upper_only else (0, 48)
    u = col_base + 30
    to_t = lambda x: torch.from_numpy(x.view(np.int32))
    a, b = R.ring_block_pairs(to_t(rows), to_t(cols), row_base=row_base,
                              col_base=col_base, u=u, max_dist=2,
                              upper_only=upper_only)
    rc = codes[:48]
    cc = rc if upper_only else codes[48:]
    want = []
    for r in range(48):
        for c in range(48):
            if (row_base + r < u and col_base + c < u
                    and (not upper_only or c > r)
                    and (rc[r] != cc[c]).sum() <= 2):
                want.append((row_base + r, col_base + c))
    assert want
    want = sorted((min(p), max(p)) for p in want)
    assert list(zip(a.tolist(), b.tolist())) == want


def test_ring_block_pairs_rejects_bad_input():
    t = torch.zeros((8, 2), dtype=torch.int32)
    kw = dict(row_base=0, col_base=0, u=8, max_dist=1, upper_only=False)
    with pytest.raises(ValueError):
        R.ring_block_pairs(t.to(torch.int64), t, **kw)
    with pytest.raises(ValueError):
        R.ring_block_pairs(t, t[:4], **kw)
    with pytest.raises(ValueError, match="upper_only"):
        R.ring_block_pairs(t, t, **{**kw, "col_base": 8, "upper_only": True})
    with pytest.raises(ValueError, match="2\\^31"):
        R.ring_block_pairs(t, t, **{**kw, "u": 1 << 31})


def test_ring_rejects_a_table_whose_keys_overflow():
    """Pair keys are a * u + b in one int64: the ring refuses u >= 2^31
    before it allocates anything (a broadcast view stands in for the
    table)."""
    table = np.broadcast_to(np.zeros((1, 2), np.uint32), (1 << 31, 2))
    with pytest.raises(ValueError, match="2\\^31"):
        P.sharded_neighbor_pairs_ring(table, 1, word_length=24,
                                      mesh=_cpu_mesh(1), block_cap=1 << 31)


def _ids_case(rng):
    codes = _dataset(rng, 600, 24, pool=5)
    packed = W.pack_words(codes)
    rows = np.zeros((768, 2), np.uint32)
    rows[:600] = packed
    ids = rng.integers(0, 4, 768).astype(np.int32)
    ii, jj = np.triu_indices(3)
    tp = np.ones((len(ii), 3), np.int32)
    tp[:, 0], tp[:, 1] = ii, jj
    kw = dict(tile=256, part_stride=768, part_valid=600, max_dist=2)
    return (codes, torch.from_numpy(rows.view(np.int32)),
            torch.from_numpy(tp), ids, kw)


def test_ids_mask_against_brute_force():
    codes, lanes, tp, ids, kw = _ids_case(np.random.default_rng(21))
    a, b = K.hamming_tile_pairs(lanes, tp, ids=torch.from_numpy(ids), **kw)
    dist = (codes[:, None, :] != codes[None, :, :]).sum(axis=2)
    ra, rb = np.nonzero(np.triu(dist <= 2, k=1)
                        & (ids[:600, None] == ids[None, :600]))
    assert len(ra) > 0
    np.testing.assert_array_equal(a.numpy(), ra)
    np.testing.assert_array_equal(b.numpy(), rb)


def test_ids_all_equal_is_the_unmasked_sweep():
    _, lanes, tp, ids, kw = _ids_case(np.random.default_rng(22))
    same = torch.full((768,), 7, dtype=torch.int32)
    want = K.hamming_tile_pairs(lanes, tp, **kw)
    got = K.hamming_tile_pairs(lanes, tp, ids=same, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    masked = K.hamming_tile_pairs(lanes, tp, ids=torch.from_numpy(ids), **kw)
    assert 0 < len(masked[0]) < len(want[0])
    with pytest.raises(ValueError, match="ids"):
        K.hamming_tile_pairs(lanes, tp, ids=same[:10], **kw)


def test_partition_runs_matches_reference():
    rng = np.random.default_rng(4)
    key = rng.integers(0, 50, 1000).astype(np.uint64)
    for got, want in zip(N._partition_runs(key), JN._partition_runs(key)):
        np.testing.assert_array_equal(got, want)


# -- connected components over the mesh, and the mesh dedup step --------

@pytest.fixture(scope="module")
def graph():
    """70,000 nodes (past the node-sharded default of 2^16), random edges
    that reach across every shard's node range (boundary messages in
    every bucket) and a 3,000-edge chain of stride 17 (a component of
    large diameter): 30,133 components."""
    rng = np.random.default_rng(3)
    n = 70_000
    a = rng.integers(0, n, 40_000)
    b = np.minimum(n - 1, a + rng.integers(1, 30_000, 40_000))
    chain = np.arange(3_000)
    return np.concatenate([a, chain]), np.concatenate([b, chain + 17]), n


@pytest.mark.parametrize("node_sharded", [False, True, None],
                         ids=["replicated", "node_sharded", "default"])
@pytest.mark.parametrize("d", [1, 3, 4])
def test_distributed_components_match_reference(graph, d, node_sharded):
    """Labels, node for node, against the JAX package's on its mesh; by
    default the port runs the replicated variant, the reference the
    node-sharded one past 2^16 nodes on several shards."""
    a, b, n = graph
    want = JP.distributed_components(a, b, n, mesh=JP.data_mesh(d),
                                     node_sharded=node_sharded)
    kw = {} if node_sharded is None else {"node_sharded": node_sharded}
    got = P.distributed_components(a, b, n, mesh=_cpu_mesh(d), **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


def test_node_shard_inputs_match_reference_prep(graph):
    """The node-sharded host prep is the reference's: every cross edge is
    a message in both directions, slot for slot on both sides."""
    a, b, n = graph
    us, ea, eb, msg_src, recv_dst = P.labelprop.node_shard_inputs(a, b, n, 4)
    assert us == 17_504 and ea.shape == eb.shape
    sent = (msg_src >= 0).sum()
    assert sent == (recv_dst < us).sum() == 2 * int(
        ((a // us) != (b // us)).sum())
    assert ((msg_src >= 0) == (recv_dst.transpose(1, 0, 2) < us)).all()


@pytest.mark.parametrize("n", [0, 1, 9])
def test_distributed_components_small(n):
    a = np.arange(max(n - 1, 0))[::2]
    want = np.arange(n)
    want[a + 1] = a
    for node_sharded in (False, True):
        got = P.distributed_components(a, a + 1, n, mesh=_cpu_mesh(3),
                                       node_sharded=node_sharded)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def dedup_table():
    """4,974 uniques: on one shard the reference's ring block spans three
    2,048-row tiles (nine tile pairs)."""
    return _uniq(_dataset(np.random.default_rng(1), 7000, 24, pool=900))


@pytest.mark.parametrize("d", [1, 3, 4])
def test_dedup_step_matches_reference(dedup_table, d):
    """Labels against the JAX dedup_step on its mesh and against the
    components of the host engine's pairs; the per-shard pair counts sum to the
    reference's per-tile counts."""
    from humid_tpu_torch.cluster import connected_components_device

    want, tile_counts = JP.dedup_step(dedup_table, 1, mesh=JP.data_mesh(d))
    got, shard_pairs = P.dedup_step(dedup_table, 1, mesh=_cpu_mesh(d))
    np.testing.assert_array_equal(got, want)
    pa, pb = N.find_neighbor_pairs(dedup_table, 1, word_length=24,
                                   strategy="runs", device="cpu")
    np.testing.assert_array_equal(
        got, connected_components_device(pa, pb, len(dedup_table), "cpu"))
    assert len(shard_pairs) == d
    assert shard_pairs.sum() == tile_counts[:, 0].sum() == len(pa)


def test_dedup_step_trivial_tables():
    for u in (0, 1):
        labels, counts = P.dedup_step(np.zeros((u, 2), np.uint32), 1,
                                      mesh=_cpu_mesh(2))
        np.testing.assert_array_equal(labels, np.arange(u))
        np.testing.assert_array_equal(counts, [0, 0])
