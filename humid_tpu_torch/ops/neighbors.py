"""Neighbour-pair search (Hamming distance).

Replaces the reference's per-word fuzzy trie traversal
(``findHammingNeighbours``, humid.cc:113-130) with sweeps over tiles of
the packed unique-word table, all of which run through one kernel, the
Hamming tile sweep (:mod:`.cuda_hamming`):

* ``dense`` — every upper-triangular tile pair of the table;
* ``bucketed`` — pigeonhole partitions: the ``max_dist + 1`` permuted
  copies of the table are stacked, and only the tile pairs that hold a
  run of words sharing a segment are swept.

Both return the same pair set: every unordered pair within ``max_dist``.
So do the engines of the local device mesh (:mod:`..parallel`), reached
through the strategies ``ring``, ``sharded`` and ``sharded_bucketed``.

CSR ordering invariant: every node's neighbour list is sorted ascending by
unique-word index.  This equals the reference's neighbour-list order — the
lexicographic outer walk (humid.cc:117) appends all lexicographically
smaller neighbours (discovered earlier) in ascending order, then all larger
neighbours (yielded by the in-order asymmetric trie search) in ascending
order (humid.cc:118-124).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import words as W
from .._device import resolve_device
from .cuda_hamming import hamming_tile_pairs
from .unique import _stable_argsort_u64, _unique_u64

STRATEGY_ENV_VAR = "HUMID_TPU_TORCH_STRATEGY"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _empty_pairs():
    return np.zeros(0, np.int64), np.zeros(0, np.int64)


def choose_engine(u: int, max_dist: int, word_length: int | None,
                  runs_threshold: int = 1 << 11) -> str:
    """The ``auto`` strategy: ``bucketed`` when the pigeonhole split
    applies and the table is large, else ``dense``.

    The JAX package routes auto through a calibrated engine choice and
    off-chip picks its host ``runs`` engine; the calibrated router and
    the host runs engine come to the port later (ROADMAP.md).  Every
    engine returns the same pair set, so the choice changes no output
    byte."""
    if max_dist >= 1 and word_length is not None and u > runs_threshold:
        return "bucketed"
    return "dense"


def sweep_tensors(rows: np.ndarray, tile_pairs: np.ndarray,
                  device: torch.device):
    """Host sweep inputs -> the kernel's tensors on ``device``: [N, w]
    uint32 ``rows`` as int32 lanes, [nb, 2] (ti, tj) as [nb, 3] int32
    (ti, tj, on=1)."""
    lanes = torch.from_numpy(
        np.ascontiguousarray(rows, np.uint32).view(np.int32)).to(device)
    tp = np.ones((len(tile_pairs), 3), np.int32)
    tp[:, :2] = tile_pairs
    return lanes, torch.from_numpy(tp).to(device)


def _tile_sweep(rows, tile_pairs, *, tile, u_pad, u, max_dist, device):
    """Sweep ``tile_pairs`` over ``rows`` (partitions of ``u_pad`` rows,
    the first ``u`` of each real); (a, b) int64 numpy, sorted."""
    lanes, tp = sweep_tensors(rows, tile_pairs, device)
    a, b = hamming_tile_pairs(lanes, tp, tile=tile, part_stride=u_pad,
                              part_valid=u, max_dist=max_dist)
    return a.cpu().numpy(), b.cpu().numpy()


def dense_inputs(packed: np.ndarray, tile: int = 2048):
    """Sweep inputs of the dense engine: (rows [u_pad, w], tile_pairs
    [nb, 2], tile, u_pad) — every upper-triangular tile pair of the table
    zero-padded to whole tiles."""
    u, w = packed.shape
    b = min(tile, _round_up(u, 256))
    u_pad = _round_up(u, b)
    rows = np.zeros((u_pad, w), np.uint32)
    rows[:u] = packed
    ii, jj = np.triu_indices(u_pad // b)
    return rows, np.stack([ii, jj], axis=1), b, u_pad


def find_neighbor_pairs(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int | None = None,
    tile: int = 2048,
    strategy: str = "auto",
    runs_threshold: int = 1 << 11,
    device: str | torch.device | None = None,
    mesh=None,
    info: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All unordered pairs (a, b), a < b, of unique words within
    ``max_dist`` differing bases.

    Args:
      packed: [U, W] uint32 unique fingerprints in ascending order.
      max_dist: distance threshold (-m flag).
      word_length: bases per word (needed by the bucketed engines).
      strategy: "dense", "bucketed", "auto" (:func:`choose_engine`), or a
        search over the local device mesh (:mod:`..parallel`): "ring" (the
        ring kernel; the reference calls it "pallas_ring"), "sharded"
        (the bucketed mesh search when ``max_dist >= 1``, ``word_length``
        is known and U > ``runs_threshold``, else the ring) or
        "sharded_bucketed" (force the bucketed mesh search).
        $HUMID_TPU_TORCH_STRATEGY replaces "auto"; an explicit argument
        wins.
      device: torch device of the sweep (see ``_device.resolve_device``).
      mesh: devices of the mesh strategies, one per shard (default:
        ``parallel.data_mesh(device=device)``, whose size
        $HUMID_TPU_TORCH_SHARDS sets).
      info: if given, a dict that receives what this call ran:
        "strategy" and, for the mesh strategies, "shards" (mesh size) and
        "ring_fallbacks" (1 if a forced ring went to the dense sweep
        because a block exceeded the ring's cap, else 0).

    Returns:
      (a, b): int64 arrays with a < b, sorted by (a, b).
    """
    u, w = packed.shape
    env_strategy = os.environ.get(STRATEGY_ENV_VAR)
    if env_strategy and strategy == "auto":
        strategy = env_strategy
    if strategy == "auto":
        strategy = choose_engine(u, max_dist, word_length, runs_threshold)
    info = {} if info is None else info
    info["strategy"] = strategy
    if u <= 1:
        return _empty_pairs()
    dev = resolve_device(device)
    if strategy in ("ring", "sharded", "sharded_bucketed"):
        return _mesh_search(packed, max_dist, strategy,
                            word_length=word_length, tile=tile,
                            runs_threshold=runs_threshold, device=dev,
                            mesh=mesh, info=info)
    if strategy == "bucketed":
        return find_neighbor_pairs_bucketed(
            packed, max_dist, word_length=word_length, tile=tile, device=dev)
    if strategy != "dense":
        raise ValueError(f"unknown strategy {strategy!r}")
    rows, tile_pairs, b, u_pad = dense_inputs(packed, tile)
    return _tile_sweep(rows, tile_pairs, tile=b, u_pad=u_pad, u=u,
                       max_dist=max_dist, device=dev)


def _mesh_search(packed, max_dist, strategy, *, word_length, tile,
                 runs_threshold, device, mesh, info):
    """The mesh strategies of :func:`find_neighbor_pairs`."""
    from .. import parallel as P

    mesh = mesh or P.data_mesh(device=device)
    info.update(shards=len(mesh), ring_fallbacks=0)
    if strategy == "sharded_bucketed" or (
            strategy == "sharded" and max_dist >= 1
            and word_length is not None and len(packed) > runs_threshold):
        if word_length is None:
            raise ValueError("sharded_bucketed strategy requires word_length")
        return P.sharded_neighbor_pairs_bucketed(
            packed, max_dist, word_length=word_length, mesh=mesh)
    if strategy == "sharded":
        return P.sharded_neighbor_pairs(packed, max_dist, mesh=mesh,
                                        word_length=word_length)
    try:
        return P.sharded_neighbor_pairs_ring(
            packed, max_dist, word_length=word_length, mesh=mesh)
    except P.RingLimitExceeded:
        # A forced ring above its block cap completes through the dense
        # tile sweep (also a kernel) rather than fail; counted, so a run
        # can show it did not happen.
        info["ring_fallbacks"] = 1
        return find_neighbor_pairs(packed, max_dist, word_length=word_length,
                                   tile=tile, strategy="dense", device=device)


def _segment_run_ids(packed: np.ndarray, word_length: int, n_seg: int):
    """Per-partition bucket keys: [n_seg][U] uint64 packed segment values.

    For words up to 32 bases (<= 2 lanes) the segment bits are extracted
    directly from a combined uint64 (base b sits at bits 62-2b ..) — no
    per-base unpacking.  Wider words fall back to unpacked codes.
    """
    bounds = [word_length * s // n_seg for s in range(n_seg + 1)]
    u, w = packed.shape
    keys = []
    if w <= 2:
        word64 = packed[:, 0].astype(np.uint64) << np.uint64(32)
        if w == 2:
            word64 |= packed[:, 1].astype(np.uint64)
        for s in range(n_seg):
            lo, hi = bounds[s], bounds[s + 1]
            width = 2 * (hi - lo)
            shift = np.uint64(64 - 2 * hi)
            mask = np.uint64((1 << width) - 1)
            keys.append((word64 >> shift) & mask)
        return keys
    codes = W.unpack_words(packed, word_length).astype(np.uint64)
    for s in range(n_seg):
        seg = codes[:, bounds[s]:bounds[s + 1]]
        k = np.zeros(len(packed), np.uint64)
        for c in range(seg.shape[1]):
            k = (k << np.uint64(2)) | seg[:, c]
        keys.append(k)
    return keys


def _partition_runs(key: np.ndarray):
    """Sorted order + equal-key run structure of one pigeonhole partition:
    (order, run_start, run_len), run_start in sorted order.  One fused
    native ``unique_u64`` call where the host extension is built, else a
    stable argsort and a compare pass."""
    n = len(key)
    if _unique_u64 is not None:
        order = np.empty(n, np.int64)
        group_start = np.empty(n, np.int64)
        counts = np.empty(n, np.int64)
        first_occ = np.empty(n, np.int64)
        inv = np.empty(1, np.int64)
        k = _unique_u64(np.ascontiguousarray(key), order, group_start,
                        counts, first_occ, inv, 0)
        return order, group_start[:k], counts[:k]
    order = _stable_argsort_u64(key)
    kperm = key[order]
    new_run = np.empty(n, bool)
    new_run[0] = True
    np.not_equal(kperm[1:], kperm[:-1], out=new_run[1:])
    run_start = np.flatnonzero(new_run)
    run_len = np.diff(np.append(run_start, n))
    return order, run_start, run_len


def _dedupe_pairs(a: np.ndarray, b: np.ndarray):
    """Sort + dedupe (a, b) pair lists via a fused uint64 key (indices
    are < 2^32)."""
    key = (a.astype(np.uint64) << np.uint64(32)) | b.astype(np.uint64)
    sk = key[_stable_argsort_u64(key)]
    if len(sk):
        keep = np.empty(len(sk), bool)
        keep[0] = True
        np.not_equal(sk[1:], sk[:-1], out=keep[1:])
        sk = sk[keep]
    return ((sk >> np.uint64(32)).astype(np.int64),
            (sk & np.uint64(0xFFFFFFFF)).astype(np.int64))


def bucketed_inputs(packed: np.ndarray, max_dist: int, word_length: int,
                    tile: int = 2048):
    """Sweep inputs of the bucketed engine: (rows [(m+1)*u_pad, w],
    tile_pairs [nb, 2], tile, u_pad, orders [m+1, u]).

    Split each word into ``max_dist + 1`` contiguous segments: a pair
    within distance m agrees exactly on at least one segment (pigeonhole).
    Per partition, words are sorted by segment key, so equal-key runs are
    contiguous, and only the tile pairs that overlap a run are listed.
    All partitions ride one sweep: the permuted copies are stacked
    (partition p occupies rows [p*u_pad, (p+1)*u_pad), its tiles offset
    by p*t), and ``orders[p]`` maps partition p's rows back to unique
    indices.  The sweep treats rows with (row % u_pad) >= u as padding —
    zero-packed padding rows decode to all-'A' words at distance 0 from
    each other, so that mask, not the packing, keeps them out.
    """
    u, w = packed.shape
    n_seg = max_dist + 1
    b = min(tile, _round_up(u, 256))
    u_pad = _round_up(u, b)
    t = u_pad // b
    datas: list[np.ndarray] = [None] * n_seg
    pair_lists: list[np.ndarray] = [None] * n_seg
    orders = np.empty((n_seg, u), np.int64)
    keys = _segment_run_ids(packed, word_length, n_seg)

    def _prep_partition(p):
        key = keys[p]
        if p == 0 and np.all(key[1:] >= key[:-1]):
            # Prefix key of the ascending unique table: identity order
            # (verified — a permuted table would silently lose pairs).
            order = np.arange(u, dtype=np.int64)
            kperm = key
            dperm = packed
        else:
            order = _stable_argsort_u64(key)
            kperm = key[order]
            dperm = packed[order]
        orders[p] = order
        new_run = np.empty(u, bool)
        new_run[0] = True
        np.not_equal(kperm[1:], kperm[:-1], out=new_run[1:])
        if u_pad > u:
            dperm = np.concatenate(
                [dperm, np.zeros((u_pad - u, w), dperm.dtype)])
        # Tile pairs: diagonal always; a run crossing tiles a..c adds the
        # tile pairs it spans (rare unless a bucket is huge).  If the
        # crossing spans approach the dense grid, take the dense grid
        # rather than enumerating in Python.
        run_starts = np.flatnonzero(new_run)
        run_ends = np.append(run_starts[1:], u)
        t0 = run_starts // b
        t1 = (run_ends - 1) // b
        cross = t1 > t0
        spans = t1[cross] - t0[cross] + 1
        extra = int((spans * (spans + 1) // 2).sum())
        if extra >= t * (t + 1) // 4:
            ii, jj = np.triu_indices(t)
            pairs_raw = np.stack([ii, jj], axis=1).astype(np.int32)
        else:
            pairs = {(i, i) for i in range(t)}
            for a0, a1 in zip(t0[cross], t1[cross]):
                for i in range(int(a0), int(a1) + 1):
                    for j in range(i, int(a1) + 1):
                        pairs.add((i, j))
            pairs_raw = np.array(sorted(pairs), np.int32).reshape(-1, 2)
        datas[p] = dperm
        pair_lists[p] = pairs_raw + np.int32(p * t)

    # Partition prep (sort + gather + run detection) is independent and
    # spends its time in GIL-releasing native/numpy calls.
    with ThreadPoolExecutor(max_workers=n_seg) as ex:
        list(ex.map(_prep_partition, range(n_seg)))
    return (np.concatenate(datas, axis=0),
            np.concatenate(pair_lists, axis=0), b, u_pad, orders)


def find_neighbor_pairs_bucketed(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    tile: int = 2048,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Subquadratic Hamming neighbour pairs via pigeonhole partitions
    (:func:`bucketed_inputs`).  Words of other runs in the swept tiles
    are compared too; any pair the sweep finds is within ``max_dist``,
    and a pair found in several partitions is deduplicated at the end.

    Complexity per partition ~ O(U/tile) diagonal tiles plus extra tiles
    for runs crossing tile boundaries — versus O((U/tile)^2) dense.
    """
    if word_length is None:
        raise ValueError("bucketed strategy requires word_length")
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        # Unique words are pairwise distinct: no pairs at distance 0.
        return _empty_pairs()
    dev = resolve_device(device)
    rows, tile_pairs, b, u_pad, orders = bucketed_inputs(
        packed, max_dist, word_length, tile)
    pa, pb = _tile_sweep(rows, tile_pairs, tile=b, u_pad=u_pad, u=u,
                         max_dist=max_dist, device=dev)
    # Stacked permuted positions -> original unique-word indices.
    ga = orders[pa // u_pad, pa % u_pad]
    gb = orders[pb // u_pad, pb % u_pad]
    # A pair agreeing on k>1 segments appears k times; dedupe + sort.
    return _dedupe_pairs(np.minimum(ga, gb), np.maximum(ga, gb))


def pairs_to_csr(
    a: np.ndarray, b: np.ndarray, num_nodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrize pair list into CSR with ascending neighbour lists.

    Returns (indptr [U+1], indices [2E]) int64.
    """
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    order = np.lexsort((dst, src))
    src = src[order]
    dst = dst[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    if len(src):
        indptr[1:] = np.bincount(src, minlength=num_nodes)
    np.cumsum(indptr, out=indptr)
    return indptr, dst
