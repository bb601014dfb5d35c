"""The bucketed mesh search after its host prep was vectorised and its
shards were put on the cards at once (humid_tpu_torch.parallel.neighbors).

``_loop_shard_inputs`` below is the prep as it was, a loop over shards
and over the runs that span tiles, kept here as the oracle: the
vectorised ``bucketed_shard_inputs`` must equal it array for array.  The
search itself is held against the JAX package's
``sharded_neighbor_pairs_bucketed`` on its 8-device virtual CPU mesh, as
tests/test_parallel.py runs it; the port runs on d CPU shards.  Pair
lists and prep arrays are integer data: tolerance 0.
"""

from contextlib import nullcontext

import numpy as np
import pytest
import torch

from humid_tpu import parallel as JP
from humid_tpu_torch import parallel as P
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import unique_words
from humid_tpu_torch.parallel import neighbors as PN


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop_shard_inputs(packed, max_dist, word_length, d, tile=512,
                       run_cap=2048):
    """The prep before vectorisation (the oracle)."""
    u, w = packed.shape
    n_seg = max_dist + 1
    keys = N._segment_run_ids(packed, word_length, n_seg)
    orders, part_l, start_l, len_l = [], [], [], []
    for p in range(n_seg):
        order, run_start, run_len = N._partition_runs(keys[p])
        orders.append(order)
        sel = run_len >= 2
        part_l.append(np.full(int(sel.sum()), p, np.int32))
        start_l.append(run_start[sel].astype(np.int64))
        len_l.append(run_len[sel].astype(np.int64))
    part_id = np.concatenate(part_l)
    r_start = np.concatenate(start_l)
    r_len = np.concatenate(len_l)
    if len(r_len) == 0:
        return None
    if int(r_len[r_len > run_cap].sum()) > u:
        raise PN.GiantRuns("giant runs")
    weights = r_len * (r_len - 1) // 2
    rank, shard = PN._snake_assign(weights, d)
    shard_tot = np.bincount(shard, weights=r_len, minlength=d)
    max_rows = int(shard_tot.max())
    b = min(tile, N._round_up(max_rows, 256))
    r_pad = N._round_up(max_rows, b)
    out = dict(tile=b, r_pad=r_pad, rows=[], ids=[], tile_pairs=[],
               urows=[], gmaps=[])
    for si in range(d):
        mine = rank[shard[rank] == si]
        l_si = r_len[mine]
        tot = int(l_si.sum())
        rows = np.zeros((r_pad, w), packed.dtype)
        ids = -np.arange(1, r_pad + 1, dtype=np.int32)
        gmap = np.full(r_pad, -1, np.int64)
        tp = set()
        if tot:
            src_pos = PN._expand_runs(r_start[mine], l_si)
            src_part = np.repeat(part_id[mine], l_si)
            idx = np.empty(tot, np.int64)
            for p in range(n_seg):
                m = src_part == p
                if m.any():
                    idx[m] = orders[p][src_pos[m]]
            gmap[:tot] = idx
            rows[:tot] = packed[idx]
            ids[:tot] = np.repeat(np.arange(len(mine), dtype=np.int32), l_si)
            offs = np.cumsum(l_si) - l_si
            t0 = offs // b
            t1 = (offs + l_si - 1) // b
            tp = {(int(t), int(t)) for t in np.unique(t0[t0 == t1])}
            spans = t0 != t1
            for s0, s1 in zip(t0[spans].tolist(), t1[spans].tolist()):
                tp.update(PN._tile_product(s0, s1, s0, s1, True))
        out["rows"].append(rows)
        out["ids"].append(ids)
        out["tile_pairs"].append(np.array(sorted(tp), np.int32).reshape(-1, 2))
        out["urows"].append(tot)
        out["gmaps"].append(gmap)
    return out


def _dataset(rng, n, length, pool=6):
    """The generator of tests/test_parallel.py."""
    base = rng.integers(0, 4, size=(pool, length)).astype(np.uint8)
    codes = base[rng.integers(0, pool, n)].copy()
    muts = rng.integers(0, length, n)
    flip = rng.random(n) < 0.7
    codes[np.arange(n)[flip], muts[flip]] = rng.integers(0, 4, flip.sum())
    return codes


def _variants(rng, pool, n, length, k):
    """n draws from ``pool`` words with k random substitutions each: long
    equal-key runs, which span tiles at every shard count."""
    base = rng.integers(0, 4, size=(pool, length)).astype(np.uint8)
    codes = base[rng.integers(0, pool, n)].copy()
    for _ in range(k):
        codes[np.arange(n), rng.integers(0, length, n)] = rng.integers(
            0, 4, n)
    return codes


def _uniq(codes):
    return unique_words(W.pack_words(codes), want_inverse=False)[0]


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64


def _same_prep(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert set(got) == set(want)
    assert (got["tile"], got["r_pad"]) == (want["tile"], want["r_pad"])
    assert got["urows"] == want["urows"]
    for k in ("rows", "ids", "tile_pairs", "gmaps"):
        assert len(got[k]) == len(want[k])
        for g, w in zip(got[k], want[k]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


#: name -> (table, max_dist, word_length, tile): many short runs; long
#: runs that span several tiles; three-lane words; a table with no run.
def _tables():
    rng = np.random.default_rng(31)
    return {
        "short_runs": (_uniq(_dataset(rng, 900, 20, pool=90)), 1, 20, 512),
        "spanning_runs": (_uniq(_variants(rng, 6, 1500, 16, 2)), 2, 16, 256),
        "w3_m2": (_uniq(_dataset(rng, 800, 40, pool=40)), 2, 40, 256),
        "no_runs": (_uniq(np.array([[0, 1, 2, 3] * 6, [3, 2, 1, 0] * 6],
                                   np.uint8)), 1, 24, 512),
    }


TABLES = _tables()


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_vectorised_prep_equals_the_loop(name, d):
    table, m, wl, tile = TABLES[name]
    want = _loop_shard_inputs(table, m, wl, d, tile)
    got = PN.bucketed_shard_inputs(table, m, wl, d, tile)
    _same_prep(got, want)
    if name == "spanning_runs":
        # The case this table is for: runs that span tiles.
        assert any((tp[:, 0] != tp[:, 1]).any() for tp in want["tile_pairs"])


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_vectorised_prep_on_a_giant_runs_table(d):
    """One template with scattered substitutions: both preps raise
    GiantRuns at a small run cap, and agree at the default one."""
    rng = np.random.default_rng(55)
    base = rng.integers(0, 4, 24).astype(np.uint8)
    codes = np.tile(base, (700, 1))
    codes[np.arange(700), rng.integers(0, 24, 700)] = rng.integers(0, 4, 700)
    uniq = _uniq(codes)
    for prep in (_loop_shard_inputs, PN.bucketed_shard_inputs):
        with pytest.raises(PN.GiantRuns):
            prep(uniq, 2, 24, d, run_cap=16)
    _same_prep(PN.bucketed_shard_inputs(uniq, 2, 24, d, 256),
               _loop_shard_inputs(uniq, 2, 24, d, 256))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", ["short_runs", "spanning_runs", "w3_m2"])
def test_mesh_search_equals_reference(name, d):
    table, m, wl, tile = TABLES[name]
    want = JP.sharded_neighbor_pairs_bucketed(
        table, m, word_length=wl, mesh=JP.data_mesh(d), cap_row=4,
        tile=tile)
    assert len(want[0]) > 0
    _same(P.sharded_neighbor_pairs_bucketed(
        table, m, word_length=wl, mesh=P.data_mesh(d, "cpu"), tile=tile),
        want)


@pytest.fixture
def emulated_cards(monkeypatch):
    """The card path (``_sweep_shards_on_cards``) run on CPU tensors: K1's
    launch is emulated by its plain version, writing into the key buffer
    and counter as the kernel does (keys past the buffer are counted, not
    written); the read-back is the counter itself.  Returns the launch
    and read-back logs."""
    from humid_tpu_torch.ops import cuda_hamming as K

    log = {"launches": [], "reads": 0}

    def launch(lanes, pairs, keys, counter, *, ids=None, **kw):
        a, b = K.hamming_tile_pairs_plain(lanes, pairs, ids=ids, **kw)
        key = a * lanes.shape[0] + b
        at = int(counter[0])
        room = max(0, min(len(key), len(keys) - at))
        keys[at:at + room] = key[:room]
        counter[0] += len(key)
        log["launches"].append(len(pairs))

    def read_back(counter):
        log["reads"] += 1
        return counter.tolist()

    monkeypatch.setattr(K, "_launch", launch)
    monkeypatch.setattr(K, "_read_back", read_back)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    return log


@pytest.mark.parametrize("caps", [(None, None), (8, None), (8, 64)],
                         ids=["fits", "rerun", "split"])
def test_card_path_logic(caps, emulated_cards, monkeypatch):
    """Every shard's launches come before any read; one read a shard, one
    more for each shard rerun with the exact capacity; past ``MAX_CAP``
    the wrapper's split takes the shard.  The pairs equal the plain
    sweep's in every case."""
    from humid_tpu_torch.ops import cuda_hamming as K

    table, m, wl, tile = TABLES["spanning_runs"]
    cap_start, max_cap = caps
    if cap_start:
        monkeypatch.setattr(K, "CAP_START", cap_start)
    if max_cap:
        monkeypatch.setattr(K, "MAX_CAP", max_cap)
    monkeypatch.setattr(K, "CHUNK_PAIRS", 2)
    prep = PN.bucketed_shard_inputs(table, m, wl, 4, tile)
    shards = [si for si in range(4) if prep["urows"][si]]
    mesh = P.data_mesh(4, "cpu")
    reads_at_launch = []
    real = K._launch

    def watching(*args, **kw):
        reads_at_launch.append(emulated_cards["reads"])
        real(*args, **kw)

    monkeypatch.setattr(K, "_launch", watching)
    got = PN._sweep_shards_on_cards(prep, mesh, m)
    chunks = sum(-(-len(prep["tile_pairs"][si]) // 2) for si in shards)
    assert reads_at_launch[:chunks] == [0] * chunks
    assert [si for si, _, _ in got] == shards
    plain = []
    for si in shards:
        lanes, tp = N.sweep_tensors(prep["rows"][si], prep["tile_pairs"][si],
                                    torch.device("cpu"))
        a, b = K.hamming_tile_pairs_plain(
            lanes, tp, tile=prep["tile"], part_stride=prep["r_pad"],
            part_valid=prep["urows"][si], max_dist=m,
            ids=torch.from_numpy(prep["ids"][si]))
        plain.append((a.numpy(), b.numpy()))
    for (_, a, b), (pa, pb) in zip(got, plain):
        order = np.lexsort((b, a))
        np.testing.assert_array_equal(a[order], pa)
        np.testing.assert_array_equal(b[order], pb)
    n_pairs = [len(pa) for pa, _ in plain]
    assert min(n_pairs) > 64
    if caps == (None, None):
        assert emulated_cards["reads"] == len(shards)
        assert len(reads_at_launch) == chunks
    elif caps == (8, None):
        assert emulated_cards["reads"] == 2 * len(shards)
        assert len(reads_at_launch) == 2 * chunks
    else:  # no rerun of its own: the wrapper (plain here) took each shard
        assert emulated_cards["reads"] == len(shards)
        assert len(reads_at_launch) == chunks
    _same(P.sharded_neighbor_pairs_bucketed(
        table, m, word_length=wl, mesh=mesh, tile=tile),
        JP.sharded_neighbor_pairs_bucketed(
            table, m, word_length=wl, mesh=JP.data_mesh(4), cap_row=4,
            tile=tile))
