"""Neighbour search over the local device mesh.

Counterpart of ``humid_tpu/parallel/neighbors.py``:

* :func:`sharded_neighbor_pairs` — the dense ring: blocks of the unique
  table rotate around the mesh and every shard compares its own block
  with each block that passes.  The reference has two of these, an XLA
  ring of ``ppermute`` collectives and the in-kernel RDMA ring of
  ``pallas_ring.py``; on CUDA both come to the same thing (copies between
  kernel launches, overlapped on a second stream), so both names lead to
  :func:`..cuda_ring.sharded_neighbor_pairs_ring`.
* :func:`sharded_neighbor_pairs_bucketed` — the pigeonhole partitions cut
  the work first: whole equal-key runs are dealt to shards, and each
  shard sweeps only the tiles its own runs span, with a run-id mask,
  through the Hamming tile sweep kernel (:mod:`..ops.cuda_hamming`).  No
  data moves between shards.

For edit distance (``metric="edit"``) the same two shapes of search run
through the banded-Levenshtein tile scan (:func:`..ops.edit.edit_tile_pairs`,
a PyTorch program, no hand-written kernel):

* :func:`sharded_neighbor_pairs` with ``metric="edit"`` — the dense edit
  ring: blocks of unpacked codes rotate on the ring kernel's schedule,
  streams and events (:mod:`.cuda_ring`);
* :func:`sharded_edit_pairs_shifted` — the (segment, shift) joins of the
  shifted-segment search: whole equal-key groups are dealt to shards, and
  each shard scans only the cross tiles its groups span, with a group-id
  mask.

All return (a, b) int64, a < b, sorted by (a, b): the contract of
``find_neighbor_pairs``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import concat_aranges
from ..ops.edit import _unpack, edit_tile_pairs
from ..ops.hamming import lanes_tensor
from ..ops.neighbors import (JoinCapExceeded, _dedupe_pairs, _empty_pairs,
                             _matching_runs, _partition_runs, _round_up,
                             _segment_run_ids, _sorted_run_counts,
                             default_join_cap, record_impl, shifted_joins,
                             sweep, sweep_tensors)
from .cuda_ring import (ring_schedule, ring_slots,
                        sharded_neighbor_pairs_ring)
from .mesh import data_mesh, pad_to_shards

__all__ = ["sharded_neighbor_pairs", "sharded_neighbor_pairs_bucketed",
           "sharded_edit_pairs_shifted"]


class GiantRuns(ValueError):
    """Equal-key runs above ``run_cap`` cover more rows than the table
    has: the bucketed layout is degenerate for this data."""


def sharded_neighbor_pairs(
    packed: np.ndarray,
    max_dist: int,
    *,
    mesh=None,
    tile: int = 2048,
    cap_row: int = 16,
    metric: str = "hamming",
    word_length: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All unordered fingerprint pairs within ``max_dist``, by the dense
    ring over the device mesh: the ring kernel for Hamming distance, the
    banded-Levenshtein tile scan (tiles of at most ``min(tile, 512)``
    rows) for ``metric="edit"``."""
    if metric == "edit":
        if word_length is None:
            raise ValueError("edit metric requires word_length")
        return _edit_ring(packed, max_dist, word_length=word_length,
                          mesh=mesh or data_mesh(device=device), tile=tile)
    if metric != "hamming":
        raise ValueError(f"unknown metric {metric!r}")
    return sharded_neighbor_pairs_ring(
        packed, max_dist, word_length=word_length, mesh=mesh,
        cap_row=cap_row, device=device)


def _edit_ring(packed, max_dist, *, word_length, mesh, tile):
    """The dense edit ring.  Every shard unpacks its block of the table
    (padded to whole tiles) on its device; the code blocks then travel as
    the ring kernel's slots do (:func:`.cuda_ring.ring_schedule`, one slot
    per step, forwarded on the copy stream while the step computes), and
    at step s shard ``me`` scans its own block against block (me + s) mod
    d.  A step's matches are compacted on the device and read as they
    are, so the host waits once per step."""
    d = len(mesh)
    u = len(packed)
    if u <= 1:
        return _empty_pairs()
    tile = min(tile, 512, _round_up(-(-u // d), 256))
    padded = pad_to_shards(packed, d, multiple=tile)
    bsh = len(padded) // d
    steps = d // 2 + 1
    shards = [ring_slots(
        _unpack(lanes_tensor(padded[me * bsh:(me + 1) * bsh], dev),
                word_length), steps, dev) for me, dev in enumerate(mesh)]
    t = bsh // tile
    ii, jj = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    all_tiles = np.stack([ii.ravel(), jj.ravel()], axis=1)
    upper_tiles = all_tiles[all_tiles[:, 0] <= all_tiles[:, 1]]
    keys = []
    for me, s, q, upper_only, emits in ring_schedule(d):
        sh = shards[me]
        if s + 1 < steps:
            sh.forward(shards[(me - 1) % d], s)
        if not emits:
            continue
        with sh.computing(s):
            r, c = edit_tile_pairs(
                sh.slots[0], sh.slots[s],
                upper_tiles if upper_only else all_tiles, tile=tile,
                max_dist=max_dist, word_length=word_length,
                row_valid=max(0, min(u - me * bsh, bsh)),
                col_valid=max(0, min(u - q * bsh, bsh)),
                upper_only=upper_only)
            ga, gb = me * bsh + r, q * bsh + c
            keys.append((torch.minimum(ga, gb) * u
                         + torch.maximum(ga, gb)).cpu().numpy())
    for sh in shards:  # the slots must outlive the copies still in flight
        sh.join()
    # Every unordered block pair is scanned by one shard: the keys are
    # disjoint, and one sort gives the (a, b) order.
    key = np.sort(np.concatenate(keys))
    return key // u, key % u


def _expand_runs(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [start, start+len) ranges into one index vector."""
    return np.repeat(starts, lens) + concat_aranges(lens)


def _snake_assign(weights: np.ndarray, d: int):
    """Heaviest-first boustrophedon deal of work items over ``d`` shards
    (approximates least-loaded greedy without a heap; balance only — the
    result is shard-independent).  Returns (rank, shard_of_item)."""
    rank = np.argsort(-weights, kind="stable")
    posn = np.empty(len(weights), np.int64)
    posn[rank] = np.arange(len(weights))
    lane = posn % d
    return rank, np.where((posn // d) % 2 == 0, lane, d - 1 - lane)


def _tile_product(a0: int, a1: int, b0: int, b1: int, upper: bool):
    """Tile pairs (i, j) with a0 <= i <= a1 and b0 <= j <= b1 (j >= i
    only, when ``upper``)."""
    return [(i, j) for i in range(a0, a1 + 1)
            for j in range(max(b0, i) if upper else b0, b1 + 1)]


def _run_tile_pairs(shard_of_run: np.ndarray, t0: np.ndarray,
                    t1: np.ndarray, d: int, n_tiles: int) -> list:
    """Per shard, the sorted distinct tile pairs (i, j), t0 <= i <= j <= t1,
    of its runs (a run within one tile gives its diagonal tile): [nb, 2]
    int32 each.  Two ragged expansions (tiles of a run, then columns of a
    tile) and one ``np.unique`` over (shard, i, j) keys."""
    run_of_i = np.repeat(np.arange(len(t0)), t1 - t0 + 1)
    i = _expand_runs(t0, t1 - t0 + 1)
    n_j = t1[run_of_i] - i + 1
    key = ((np.repeat(shard_of_run[run_of_i], n_j) * n_tiles
            + np.repeat(i, n_j)) * n_tiles + _expand_runs(i, n_j))
    key = np.unique(key)
    ij = np.stack([key // n_tiles % n_tiles, key % n_tiles],
                  axis=1).astype(np.int32)
    cut = np.searchsorted(key // (n_tiles * n_tiles), np.arange(d + 1))
    return [ij[cut[si]:cut[si + 1]] for si in range(d)]


def bucketed_shard_inputs(packed: np.ndarray, max_dist: int,
                          word_length: int, d: int, tile: int = 512,
                          run_cap: int = 2048):
    """Host prep of the bucketed mesh search: partitions -> runs -> shard
    assignment -> per-shard sweep inputs.

    Returns ``None`` when no run holds two words and raises
    :class:`GiantRuns` when giant runs make the layout degenerate (see
    :func:`sharded_neighbor_pairs_bucketed`), else a dict with ``tile``,
    ``r_pad`` and, per shard, ``rows`` [r_pad, w] uint32, ``ids`` [r_pad]
    int32 (padding rows carry distinct negative ids), ``tile_pairs``
    [nb, 2] int32, ``urows`` (real rows) and ``gmaps`` (row -> unique
    index).  The reference pads the tile count and the tile-pair lists to
    powers of two so that XLA reuses compiled programs; the tile sweep
    takes a ragged list per launch, so neither padding is kept.  Every
    step is one numpy pass over all shards' runs together."""
    u, w = packed.shape
    n_seg = max_dist + 1
    keys = _segment_run_ids(packed, word_length, n_seg)
    orders: list[np.ndarray] = []
    part_l, start_l, len_l = [], [], []
    for p in range(n_seg):
        order, run_start, run_len = _partition_runs(keys[p])
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
        raise GiantRuns(f"runs above {run_cap} words hold "
                        f"{int(r_len[r_len > run_cap].sum())} rows of {u}")

    # Heaviest-first snake assignment by descending pair count.
    weights = r_len * (r_len - 1) // 2
    rank, shard = _snake_assign(weights, d)
    shard_tot = np.bincount(shard, weights=r_len, minlength=d).astype(
        np.int64)
    max_rows = int(shard_tot.max())
    b = min(tile, _round_up(max_rows, 256))
    r_pad = _round_up(max_rows, b)

    # The runs shard by shard, heaviest first within a shard; a shard's
    # rows are its runs back to back from row 0.
    runs = rank[np.argsort(shard[rank], kind="stable")]
    lens = r_len[runs]
    shard_of_run = shard[runs].astype(np.int64)
    first_row = np.cumsum(shard_tot) - shard_tot
    offs = np.cumsum(lens) - lens - first_row[shard_of_run]
    n_runs = np.bincount(shard_of_run, minlength=d)
    run_id = np.arange(len(runs)) - (np.cumsum(n_runs) - n_runs)[
        shard_of_run]
    # One gather for every shard: (partition, sorted position) -> unique
    # index, to row (shard, offset).
    idx = np.concatenate(orders)[np.repeat(part_id[runs] * np.int64(u),
                                           lens)
                                 + _expand_runs(r_start[runs], lens)]
    dest = _expand_runs(shard_of_run * r_pad + offs, lens)
    rows = np.zeros((d * r_pad, w), packed.dtype)
    rows[dest] = packed[idx]
    gmaps = np.full(d * r_pad, -1, np.int64)
    gmaps[dest] = idx
    # Padding rows carry distinct negative ids so they never match.
    ids = np.tile(-np.arange(1, r_pad + 1, dtype=np.int32), d)
    ids[dest] = np.repeat(run_id, lens).astype(np.int32)
    tile_pairs = _run_tile_pairs(shard_of_run, offs // b,
                                 (offs + lens - 1) // b, d, r_pad // b)
    cut = lambda a: [a[si * r_pad:(si + 1) * r_pad] for si in range(d)]
    return dict(tile=b, r_pad=r_pad, rows=cut(rows), ids=cut(ids),
                tile_pairs=tile_pairs,
                urows=[int(t) for t in shard_tot], gmaps=cut(gmaps))


def _sweep_shards_on_cards(prep: dict, mesh, max_dist: int,
                           cap_start: int | None = None) -> list:
    """The tile sweep of every shard with rows, on the cards of ``mesh``
    at once: first every shard's uploads (pinned, without a wait) and its
    own key buffer (of ``cap_start`` keys at most, default K1's
    ``CAP_START``) and counter, then every shard's K1 launches back to
    back, each on its card's current stream; only then the reads.  The
    counters are read once per shard; a shard whose buffer overflowed is
    swept again with the exact capacity (all such reruns enqueued before
    their reads), or through
    :func:`..ops.cuda_hamming.hamming_tile_pairs`, which splits the work,
    where that capacity exceeds ``MAX_CAP``.  Then each shard's keys come
    back in one copy.  Returns (shard, a, b) of numpy row indices into
    that shard's rows."""
    from .. import _device
    from ..ops import cuda_hamming as K

    shards = []
    for si, dev in enumerate(mesh):
        if not prep["urows"][si]:
            continue
        tp = np.ones((len(prep["tile_pairs"][si]), 3), np.int32)
        tp[:, :2] = prep["tile_pairs"][si]
        with torch.cuda.device(dev):
            lanes = _device.to_device(np.ascontiguousarray(
                prep["rows"][si], np.uint32).view(np.int32), dev)
            shards.append(dict(
                si=si, lanes=lanes, tp=_device.to_device(tp, dev),
                kw=dict(tile=prep["tile"], part_stride=prep["r_pad"],
                        part_valid=prep["urows"][si], max_dist=max_dist,
                        ids=_device.to_device(prep["ids"][si], dev))))

    def enqueue(group, cap):
        for sh in group:
            dev = sh["lanes"].device
            with torch.cuda.device(dev):
                sh["keys"] = torch.empty(cap(sh), dtype=torch.int64,
                                         device=dev)
                sh["counter"] = torch.zeros(2, dtype=torch.int64,
                                            device=dev)
        for sh in group:
            for lo in range(0, len(sh["tp"]), K.CHUNK_PAIRS):
                K._launch(sh["lanes"], sh["tp"][lo:lo + K.CHUNK_PAIRS],
                          sh["keys"], sh["counter"], **sh["kw"])

    for sh in shards:
        K._check(sh["lanes"], sh["tp"], **sh["kw"])
    first = K.CAP_START if cap_start is None else cap_start
    enqueue(shards, lambda sh: min(first,
                                   len(sh["tp"]) * prep["tile"] ** 2))
    for sh in shards:
        sh["n"], bad = K._read_back(sh["counter"])
        if bad:
            raise ValueError(K._BAD_TILE_PAIR)
    reruns = [sh for sh in shards
              if len(sh["keys"]) < sh["n"] <= K.MAX_CAP]
    enqueue(reruns, lambda sh: sh["n"])
    for sh in reruns:
        sh["n"] = K._read_back(sh["counter"])[0]
    out = []
    for sh in shards:
        if sh["n"] > len(sh["keys"]):
            a, b = K.hamming_tile_pairs(sh["lanes"], sh["tp"], **sh["kw"])
            a, b = _device.to_host(a, b)
        else:
            (key,) = _device.to_host(sh["keys"][:sh["n"]])
            a, b = np.divmod(key, prep["r_pad"])
        out.append((sh["si"], a, b))
    return out


def sharded_neighbor_pairs_bucketed(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    mesh=None,
    tile: int = 512,
    cap_row: int = 16,
    run_cap: int = 2048,
    device: str | torch.device | None = None,
    impl: str | None = None,
    cap_total: int | None = None,
    info: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Subquadratic mesh neighbour search: pigeonhole runs sharded over
    the device mesh.

    A pair within Hamming distance m agrees exactly on one of the m + 1
    contiguous word segments.  Per partition, words are sorted by segment
    key and only equal-key runs can hold matches.  Whole runs are dealt to
    shards (balanced on len·(len−1)/2), so every shard sweeps only the
    tiles its own runs span, with run-id masking, and nothing moves
    between shards during the sweep.  Cross-partition duplicates are
    removed on the host.

    Degenerate data (giant equal-key runs covering most of the table in
    several partitions) would stack near-full copies of the table on the
    shards that own the giants; it goes to the dense ring instead, which
    does O(U²/d) work uniformly (``info["impl"]``, if asked for, then
    becomes "pallas_ring": :func:`..ops.neighbors.record_impl`).

    On cards every shard is swept at once, as the reference's
    ``shard_map`` does (:func:`_sweep_shards_on_cards`); shards placed on
    one card share its stream.  On the CPU, or with ``impl`` "xor" or
    "mxu", the shards run that sweep in turn
    (:func:`..ops.neighbors.sweep`, first capacity ``cap_total``)."""
    mesh = mesh or data_mesh(device=device)
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        return _empty_pairs()
    try:
        prep = bucketed_shard_inputs(packed, max_dist, word_length,
                                     len(mesh), tile, run_cap)
    except GiantRuns:
        record_impl(info, impl, ring=True)
        return sharded_neighbor_pairs(packed, max_dist, mesh=mesh,
                                      cap_row=cap_row,
                                      word_length=word_length)
    if prep is None:
        return _empty_pairs()
    if mesh[0].type == "cuda" and impl in (None, "pallas", "pallas_ring"):
        found = _sweep_shards_on_cards(prep, mesh, max_dist, cap_total)
    else:
        found = []
        for si, dev in enumerate(mesh):
            if not prep["urows"][si]:
                continue
            lanes, tp = sweep_tensors(prep["rows"][si],
                                      prep["tile_pairs"][si], dev)
            a, b = sweep(
                lanes, tp, impl=impl, word_length=word_length,
                cap_total=cap_total,
                tile=prep["tile"], part_stride=prep["r_pad"],
                part_valid=prep["urows"][si], max_dist=max_dist,
                ids=torch.from_numpy(prep["ids"][si]).to(dev))
            found.append((si, a.cpu().numpy(), b.cpu().numpy()))
    if not found:
        return _empty_pairs()
    parts_a, parts_b = [], []
    for si, a, b in found:
        ga, gb = prep["gmaps"][si][a], prep["gmaps"][si][b]
        parts_a.append(np.minimum(ga, gb))
        parts_b.append(np.maximum(ga, gb))
    return _dedupe_pairs(np.concatenate(parts_a), np.concatenate(parts_b))


def shifted_shard_inputs(packed: np.ndarray, max_dist: int, word_length: int,
                         d: int, tile: int = 512,
                         join_cap: int | None = None):
    """Host prep of the shifted mesh search: (segment, shift) joins ->
    equal-key groups -> shard assignment -> per-shard scan inputs.

    A group is a run of rows in the canonical sort order (its A side) and
    the run with the same key in the shifted sort order (its B side); its
    candidates are the cross product, or the unordered in-run pairs for a
    shift-0 self join, whose singleton groups hold no pair and are
    dropped.  Whole groups are dealt to shards heaviest first.

    Returns ``None`` when no group holds a candidate, else a dict with
    ``tile``, ``candidates`` and, per shard, ``rows_a``/``rows_b`` (packed
    rows, whole tiles), ``ids_a``/``ids_b`` (group ids; padding rows carry
    negative ids, distinct per side), ``valid_a``/``valid_b`` (real rows),
    ``gmap_a``/``gmap_b`` (row -> unique index) and ``tile_pairs``.
    Raises :class:`..ops.neighbors.JoinCapExceeded` when a join holds more
    than ``join_cap`` candidates."""
    if join_cap is None:
        join_cap = default_join_cap()
    w = packed.shape[1]
    orders_a, orders_b = [], []    # per join: canonical / shifted order
    g_join, g_self = [], []        # per group: its join, is it a self join
    g_as, g_al, g_bs, g_bl = [], [], [], []  # run start and length per side
    for s, dd, ka, oa, kb, ob in shifted_joins(packed, max_dist,
                                               word_length):
        va, ca = _sorted_run_counts(ka[oa])
        a_starts = np.cumsum(ca) - ca
        if dd == 0:
            sel_a = sel_b = np.flatnonzero(ca >= 2)
            cb, b_starts = ca, a_starts
            need = int((ca * (ca - 1) // 2).sum())
        else:
            vb, cb = _sorted_run_counts(kb[ob])
            b_starts = np.cumsum(cb) - cb
            sel_a, sel_b = _matching_runs(va, vb)
            need = int((ca[sel_a] * cb[sel_b]).sum())
        if need > join_cap:
            raise JoinCapExceeded(
                f"sharded shifted-segment join (segment {s}, shift {dd}) "
                f"needs {need} candidates (> join_cap={join_cap}); use the "
                "dense edit ring")
        if not len(sel_a):
            continue
        g_as.append(a_starts[sel_a])
        g_al.append(ca[sel_a])
        g_bs.append(b_starts[sel_b])
        g_bl.append(cb[sel_b])
        g_join.append(np.full(len(sel_a), len(orders_a), np.int32))
        g_self.append(np.full(len(sel_a), dd == 0))
        orders_a.append(oa)
        orders_b.append(ob)
    if not g_as:
        return None
    g_as, g_al, g_bs, g_bl, g_join, g_self = (
        np.concatenate(x) for x in (g_as, g_al, g_bs, g_bl, g_join, g_self))

    weights = np.where(g_self, g_al * (g_al - 1) // 2, g_al * g_bl)
    rank, shard = _snake_assign(weights, d)
    most_rows = int(max(np.bincount(shard, weights=g_al, minlength=d).max(),
                        np.bincount(shard, weights=g_bl, minlength=d).max()))
    b = min(tile, 512, _round_up(most_rows, 256))
    out = dict(tile=b, candidates=int(weights.sum()), shards=[])
    for si in range(d):
        mine = rank[shard[rank] == si]
        # Self-join groups first, in the same order on both sides: their
        # A and B runs have equal lengths, so each sits at the same offset
        # on both sides, element i < j implies tile(i) <= tile(j), and
        # its upper-triangle tile pairs cover every unordered pair.
        mine = np.concatenate([mine[g_self[mine]], mine[~g_self[mine]]])
        al, bl = g_al[mine], g_bl[mine]
        sides = []
        for starts, lens, orders in ((g_as[mine], al, orders_a),
                                     (g_bs[mine], bl, orders_b)):
            n = int(lens.sum())
            src = _expand_runs(starts, lens)
            join_of = np.repeat(g_join[mine], lens)
            idx = np.empty(n, np.int64)
            for jn in np.unique(g_join[mine]):
                sel = join_of == jn
                idx[sel] = orders[jn][src[sel]]
            n_pad = _round_up(max(n, 1), b)
            rows = np.zeros((n_pad, w), packed.dtype)
            rows[:n] = packed[idx]
            gmap = np.full(n_pad, -1, np.int64)
            gmap[:n] = idx
            sides.append((rows, gmap, n, n_pad))
        (rows_a, gmap_a, n_a, pad_a), (rows_b, gmap_b, n_b, pad_b) = sides
        gids = np.arange(len(mine), dtype=np.int32)
        ids_a = -np.arange(1, pad_a + 1, dtype=np.int32)
        ids_b = -np.arange(pad_a + 1, pad_a + pad_b + 1, dtype=np.int32)
        ids_a[:n_a] = np.repeat(gids, al)
        ids_b[:n_b] = np.repeat(gids, bl)
        # Cross tiles each group spans: (A tiles) x (B tiles); the common
        # single-tile groups vectorized, the others in a loop.
        offs_a, offs_b = np.cumsum(al) - al, np.cumsum(bl) - bl
        ta0, ta1 = offs_a // b, (offs_a + al - 1) // b
        tb0, tb1 = offs_b // b, (offs_b + bl - 1) // b
        one = (ta0 == ta1) & (tb0 == tb1)
        tp = set(zip(ta0[one].tolist(), tb0[one].tolist()))
        for k in np.flatnonzero(~one):
            tp.update(_tile_product(int(ta0[k]), int(ta1[k]), int(tb0[k]),
                                    int(tb1[k]), bool(g_self[mine[k]])))
        out["shards"].append(dict(
            rows_a=rows_a, rows_b=rows_b, ids_a=ids_a, ids_b=ids_b,
            valid_a=n_a, valid_b=n_b, gmap_a=gmap_a, gmap_b=gmap_b,
            tile_pairs=np.array(sorted(tp), np.int64).reshape(-1, 2)))
    return out


def sharded_edit_pairs_shifted(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    mesh=None,
    tile: int = 512,
    join_cap: int | None = None,
    device: str | torch.device | None = None,
    info: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Subquadratic edit-distance neighbour search on the mesh: the
    (segment, shift) joins of the shifted-segment search
    (:func:`..ops.neighbors.find_edit_pairs_shifted`) sharded over the
    devices.

    For every (segment, shift) the equal-key groups of (canonical keys) x
    (shifted keys) hold all candidates; whole groups are dealt to shards
    (heaviest first on their candidate count), and each shard runs the
    banded-Levenshtein tile scan over only the cross tiles its groups
    span, with a group-id mask: candidates are verified in the same pass
    and nothing moves between shards.  Duplicates across joins, and a
    word meeting itself under a shifted key, are removed on the host.

    A join above ``join_cap`` raises
    :class:`..ops.neighbors.JoinCapExceeded` (callers fall back to the
    dense edit ring).  ``info["candidates"]`` receives the joins' total.
    The shards are scanned in turn, each on its own device."""
    mesh = mesh or data_mesh(device=device)
    if len(packed) <= 1 or max_dist == 0:
        return _empty_pairs()
    prep = shifted_shard_inputs(packed, max_dist, word_length, len(mesh),
                                tile, join_cap)
    if info is not None:
        info["candidates"] = prep["candidates"] if prep else 0
    if prep is None:
        return _empty_pairs()
    parts_a, parts_b = [], []
    for sh, dev in zip(prep["shards"], mesh):
        if not len(sh["tile_pairs"]):
            continue
        r, c = edit_tile_pairs(
            _unpack(lanes_tensor(sh["rows_a"], dev), word_length),
            _unpack(lanes_tensor(sh["rows_b"], dev), word_length),
            sh["tile_pairs"], tile=prep["tile"], max_dist=max_dist,
            word_length=word_length, row_valid=sh["valid_a"],
            col_valid=sh["valid_b"], upper_only=False,
            row_ids=torch.from_numpy(sh["ids_a"]).to(dev),
            col_ids=torch.from_numpy(sh["ids_b"]).to(dev))
        ga = sh["gmap_a"][r.cpu().numpy()]
        gb = sh["gmap_b"][c.cpu().numpy()]
        keep = ga != gb  # a word can meet itself under a shifted key
        parts_a.append(np.minimum(ga[keep], gb[keep]))
        parts_b.append(np.maximum(ga[keep], gb[keep]))
    if not parts_a:
        return _empty_pairs()
    return _dedupe_pairs(np.concatenate(parts_a), np.concatenate(parts_b))
