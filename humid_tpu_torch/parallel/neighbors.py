"""Neighbour search over the local device mesh (Hamming distance).

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

Both return (a, b) int64, a < b, sorted by (a, b): the contract of
``find_neighbor_pairs``.  The edit metric on the mesh waits for the
port of ``ops/edit.py`` (ROADMAP item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import concat_aranges
from ..ops.cuda_hamming import hamming_tile_pairs
from ..ops.neighbors import (_dedupe_pairs, _empty_pairs, _partition_runs,
                             _round_up, _segment_run_ids, sweep_tensors)
from .cuda_ring import sharded_neighbor_pairs_ring
from .mesh import data_mesh

__all__ = ["sharded_neighbor_pairs", "sharded_neighbor_pairs_bucketed"]


class GiantRuns(ValueError):
    """Equal-key runs above ``run_cap`` cover more rows than the table
    has: the bucketed layout is degenerate for this data."""


def sharded_neighbor_pairs(
    packed: np.ndarray,
    max_dist: int,
    *,
    mesh=None,
    cap_row: int = 16,
    metric: str = "hamming",
    word_length: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All unordered fingerprint pairs within ``max_dist``, by the dense
    ring over the device mesh."""
    if metric == "edit":
        raise NotImplementedError(
            "the edit metric on the mesh is not yet ported (ROADMAP item 9)")
    if metric != "hamming":
        raise ValueError(f"unknown metric {metric!r}")
    return sharded_neighbor_pairs_ring(
        packed, max_dist, word_length=word_length, mesh=mesh,
        cap_row=cap_row, device=device)


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
    takes a ragged list per launch, so neither padding is kept."""
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
    shard_tot = np.bincount(shard, weights=r_len, minlength=d)
    max_rows = int(shard_tot.max())
    b = min(tile, _round_up(max_rows, 256))
    r_pad = _round_up(max_rows, b)

    out = dict(tile=b, r_pad=r_pad, rows=[], ids=[], tile_pairs=[],
               urows=[], gmaps=[])
    for si in range(d):
        mine = rank[shard[rank] == si]  # this shard's runs, heaviest first
        l_si = r_len[mine]
        tot = int(l_si.sum())
        rows = np.zeros((r_pad, w), packed.dtype)
        # Padding rows carry distinct negative ids so they never match.
        ids = -np.arange(1, r_pad + 1, dtype=np.int32)
        gmap = np.full(r_pad, -1, np.int64)
        tp: set = set()
        if tot:
            # Row gather: expand each run's sorted-order range;
            # destinations are contiguous because offsets are the cumsum
            # of run lengths.
            src_pos = _expand_runs(r_start[mine], l_si)
            src_part = np.repeat(part_id[mine], l_si)
            idx = np.empty(tot, np.int64)
            for p in range(n_seg):
                m = src_part == p
                if m.any():
                    idx[m] = orders[p][src_pos[m]]
            gmap[:tot] = idx
            rows[:tot] = packed[idx]
            ids[:tot] = np.repeat(np.arange(len(mine), dtype=np.int32), l_si)
            # Tile pairs: single-tile runs contribute their diagonal tile
            # (the common case, vectorized); runs spanning tiles add
            # their block squares in a loop over that rare subset.
            offs = np.cumsum(l_si) - l_si
            t0 = offs // b
            t1 = (offs + l_si - 1) // b
            tp = {(int(t), int(t)) for t in np.unique(t0[t0 == t1])}
            spans = t0 != t1
            for s0, s1 in zip(t0[spans].tolist(), t1[spans].tolist()):
                for i in range(s0, s1 + 1):
                    for j in range(i, s1 + 1):
                        tp.add((i, j))
        out["rows"].append(rows)
        out["ids"].append(ids)
        out["tile_pairs"].append(np.array(sorted(tp), np.int32).reshape(-1, 2))
        out["urows"].append(tot)
        out["gmaps"].append(gmap)
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
    does O(U²/d) work uniformly.

    The shards are swept in turn, each on its own device."""
    mesh = mesh or data_mesh(device=device)
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        return _empty_pairs()
    try:
        prep = bucketed_shard_inputs(packed, max_dist, word_length,
                                     len(mesh), tile, run_cap)
    except GiantRuns:
        return sharded_neighbor_pairs(packed, max_dist, mesh=mesh,
                                      cap_row=cap_row,
                                      word_length=word_length)
    if prep is None:
        return _empty_pairs()
    parts_a, parts_b = [], []
    for si, dev in enumerate(mesh):
        if not prep["urows"][si]:
            continue
        lanes, tp = sweep_tensors(prep["rows"][si], prep["tile_pairs"][si],
                                  dev)
        ids = torch.from_numpy(prep["ids"][si]).to(dev)
        a, b = hamming_tile_pairs(
            lanes, tp, tile=prep["tile"], part_stride=prep["r_pad"],
            part_valid=prep["urows"][si], max_dist=max_dist, ids=ids)
        a, b = a.cpu().numpy(), b.cpu().numpy()
        ga, gb = prep["gmaps"][si][a], prep["gmaps"][si][b]
        parts_a.append(np.minimum(ga, gb))
        parts_b.append(np.maximum(ga, gb))
    if not parts_a:
        return _empty_pairs()
    return _dedupe_pairs(np.concatenate(parts_a), np.concatenate(parts_b))
