"""Neighbour-pair search (Hamming and edit distance).

Replaces the reference's per-word fuzzy trie traversal
(``findHammingNeighbours``/``findEditNeighbours``, humid.cc:113-158).

Hamming distance, by the pigeonhole principle where it applies (a pair
within distance m agrees exactly on one of m + 1 contiguous segments):

* ``dense`` — every upper-triangular tile pair of the table through the
  Hamming tile sweep (:mod:`.cuda_hamming`);
* ``bucketed`` — the ``max_dist + 1`` permuted copies of the table are
  stacked, and only the tile pairs that hold a run of words sharing a
  segment are swept by the same kernel;
* ``runs`` — the equal-segment runs of each partition are enumerated on
  the host and their pairs filtered by XOR + popcount
  (:func:`find_neighbor_pairs_runs`); runs longer than ``run_cap`` go to
  the tile sweep with its run-id mask (:func:`_big_run_pairs`);
* ``runs_device`` — the same runs evaluated on the device by offset-shift
  sweeps (:mod:`.runs_device`).

Edit distance (``metric="edit"``, the ``-e`` flag), through the banded
Levenshtein programs of :mod:`.edit`:

* ``dense`` — the same tile pairs through the batched tile scan;
* ``runs`` — the shifted-segment search
  (:func:`find_edit_pairs_shifted`): equal-key merge joins per (segment,
  shift) on the host give candidate pairs, which the pairwise DP
  verifies on the device.

Every engine of a metric returns the same pair set: every unordered pair
within ``max_dist``.  So do the engines of the local device mesh
(:mod:`..parallel`), reached through the strategies ``ring``, ``sharded``
and ``sharded_bucketed``.

Host sharding (``shard=(part, n_parts)``, the multi-process pipeline of
:mod:`..parallel.pipeline`): each part computes a slice of the candidate
work that no other part computes — pigeonhole runs and shifted join keys
by a salted hash of the key (:func:`_owned_mask`), tile pairs by
striping — and the deduplicated union of the parts is the unsharded pair
list.  Every decision that picks a partitioning (the engine, the
giant-run fallback, the join cap) is made from quantities every part
sees alike, so the parts' slices tile the whole.

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
from .._util import avail_bytes, concat_aranges
from . import edit as E
from .cuda_hamming import _sorted_pairs, hamming_tile_pairs
from .hamming import lanes_tensor
from .unique import _stable_argsort_u64, _unique_u64

try:
    from .._hostops import merge_join_pairs as _merge_join_native
    from .._hostops import run_pairs as _run_pairs_native
    from .._hostops import run_pairs_hamming as _run_pairs_hamming_native
except ImportError:  # pragma: no cover - extension not built
    _merge_join_native = _run_pairs_native = _run_pairs_hamming_native = None

STRATEGY_ENV_VAR = "HUMID_TPU_TORCH_STRATEGY"


class JoinCapExceeded(ValueError):
    """A shifted-segment join needs more candidate pairs than ``join_cap``
    allows (degenerate key space).  The auto strategy falls back to the
    dense edit scan on this, and only this, error."""


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _empty_pairs():
    return np.zeros(0, np.int64), np.zeros(0, np.int64)


_U64 = (1 << 64) - 1


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized, wrap-around uint64 arithmetic)."""
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _salt(salt_idx: int) -> int:
    return ((2 * salt_idx + 1) * 0xD1B54A32D192ED03) & _U64


def _owned_mask(key: np.ndarray, shard: tuple[int, int],
                salt_idx: int) -> np.ndarray:
    """Host-sharding ownership of a key (a pigeonhole run's, a shifted
    join's, a component's): ``mix64(key ^ salt) % n_parts == part``.

    An equal-key run belongs to exactly one part, decided by the key
    itself, so every part derives the same owner without communication:
    the union of the parts' pair lists is the full pair set, while each
    part's candidate work is ~1/n_parts.  ``salt_idx`` decorrelates the
    assignment across partitions, (segment, shift) joins and uses."""
    part, n_parts = shard
    salt = np.uint64(_salt(salt_idx))
    return (_mix64(key ^ salt) % np.uint64(n_parts)) == np.uint64(part)


def _check_shard(shard):
    """``shard`` validated; None for no shard or a single part."""
    if shard is None:
        return None
    part, n_parts = (int(v) for v in shard)
    if not 0 <= part < n_parts:
        raise ValueError(f"invalid shard {shard!r}")
    return None if n_parts == 1 else (part, n_parts)


def choose_engine(u: int, max_dist: int, word_length: int | None,
                  runs_threshold: int = 1 << 11,
                  metric: str = "hamming",
                  device: str | torch.device | None = None) -> str:
    """The ``auto`` strategy: when the segment split applies and the table
    is large, ``runs`` (the shifted-segment search) for edit distance and
    for Hamming distance the calibrated router's pick on ``device``
    (:func:`humid_tpu_torch._backend.pick_neighbor_engine`: host ``runs``
    on the CPU, else the engine predicted fastest at ``u`` on this card
    and host, ``dense`` among them); else ``dense``.  Every engine returns the same pair set, so the choice
    changes no output byte."""
    if max_dist >= 1 and word_length is not None and u > runs_threshold:
        if metric == "edit":
            return "runs"
        from .._backend import pick_neighbor_engine

        return pick_neighbor_engine(resolve_device(device), u)
    return "dense"


def sweep_tensors(rows: np.ndarray, tile_pairs: np.ndarray,
                  device: torch.device):
    """Host sweep inputs -> the kernel's tensors on ``device``: [N, w]
    uint32 ``rows`` as int32 lanes, [nb, 2] (ti, tj) as [nb, 3] int32
    (ti, tj, on=1)."""
    lanes = lanes_tensor(rows, device)
    tp = np.ones((len(tile_pairs), 3), np.int32)
    tp[:, :2] = tile_pairs
    return lanes, torch.from_numpy(tp).to(device)


def _tile_sweep(rows, tile_pairs, *, tile, u_pad, u, max_dist, device,
                ids=None):
    """Sweep ``tile_pairs`` over ``rows`` (partitions of ``u_pad`` rows,
    the first ``u`` of each real), with the run-id mask of ``ids`` ([N]
    int32 numpy) if given; (a, b) int64 numpy, sorted."""
    lanes, tp = sweep_tensors(rows, tile_pairs, device)
    if ids is not None:
        ids = torch.from_numpy(ids).to(device)
    a, b = hamming_tile_pairs(lanes, tp, tile=tile, part_stride=u_pad,
                              part_valid=u, max_dist=max_dist, ids=ids)
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
    metric: str = "hamming",
    word_length: int | None = None,
    tile: int = 2048,
    strategy: str = "auto",
    runs_threshold: int = 1 << 11,
    join_cap: int | None = None,
    device: str | torch.device | None = None,
    mesh=None,
    info: dict | None = None,
    shard: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All unordered pairs (a, b), a < b, of unique words within
    ``max_dist``.

    Args:
      packed: [U, W] uint32 unique fingerprints in ascending order.
      max_dist: distance threshold (-m flag).
      metric: "hamming" (differing bases) or "edit" (Levenshtein, the -e
        flag; needs ``word_length``).
      word_length: bases per word (needed by every engine but the dense
        Hamming sweep).
      strategy: "dense"; "bucketed", "runs_device" (Hamming only);
        "runs" (Hamming: the host pigeonhole runs engine; edit: the
        shifted-segment search); "auto" (:func:`choose_engine`); or a
        search over the local device mesh (:mod:`..parallel`): "ring"
        (the Hamming ring kernel; the reference calls it "pallas_ring"),
        "sharded" (above ``runs_threshold`` with ``max_dist >= 1`` the
        bucketed mesh search, for edit the shifted mesh search; else the
        dense ring of the metric) or "sharded_bucketed" (force the
        bucketed mesh search; Hamming only).
        $HUMID_TPU_TORCH_STRATEGY replaces "auto"; an explicit argument
        wins.
      join_cap: most candidate pairs one (segment, shift) join of the
        shifted edit searches may produce (default: a quarter of the
        host's available memory at 16 bytes a pair, at least 2^26).
        Beyond it :class:`JoinCapExceeded` is raised; "auto" and
        "sharded" then complete through the dense engine.
      device: torch device of the search (see ``_device.resolve_device``).
      mesh: devices of the mesh strategies, one per shard (default:
        ``parallel.data_mesh(device=device)``, whose size
        $HUMID_TPU_TORCH_SHARDS sets).
      info: if given, a dict that receives what this call ran: "metric",
        "strategy" (the engine that produced the pairs), for the mesh
        strategies "shards" (mesh size) and "ring_fallbacks" (1 if a
        forced ring went to the dense sweep because a block exceeded the
        ring's cap, else 0), and for the shifted edit searches
        "candidates" (pairs the joins produced) and "join_cap_fallbacks"
        (1 if the search went to the dense engine because a join exceeded
        ``join_cap``, else 0); for the pigeonhole runs engines
        "candidates" (in-run pairs), "dense_fallbacks" (1 if giant runs
        sent the search to the dense sweep, else 0) and, on the device,
        "d_max" (the sweep depth); under a shard also "shard".
      shard: optional (part, n_parts) host shard (module docstring): the
        part's slice of the candidate work, by the engine's own rule.
        "auto" under a shard takes host ``runs`` above the size gate (a
        multi-process run passes the engine every process agreed on);
        the mesh strategies ignore it and search the whole table.  One
        part is no shard.

    Returns:
      (a, b): int64 arrays with a < b, sorted by (a, b).
    """
    u, w = packed.shape
    if metric not in ("hamming", "edit"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "edit" and word_length is None:
        raise ValueError("edit metric requires word_length")
    shard = _check_shard(shard)
    env_strategy = os.environ.get(STRATEGY_ENV_VAR)
    if env_strategy and strategy == "auto":
        strategy = env_strategy
    dev = resolve_device(device)
    auto_chosen = strategy == "auto"
    if auto_chosen:
        strategy = choose_engine(u, max_dist, word_length, runs_threshold,
                                 metric, dev)
        if shard is not None and strategy not in ("dense", "runs"):
            # Every part must run the same engine; the calibrated pick of
            # this process alone is not agreed, so a bare auto keeps the
            # host engine (a multi-process run broadcasts one).
            strategy = "runs"
    info = {} if info is None else info
    info.update(metric=metric, strategy=strategy)
    if shard is not None:
        info["shard"] = shard
    if metric == "edit" and strategy in ("bucketed", "runs_device"):
        raise ValueError(
            f"{strategy} strategy supports only the hamming metric "
            "(pigeonhole segments do not bound edit distance)")
    if u <= 1:
        return _empty_pairs()
    if strategy in ("ring", "sharded", "sharded_bucketed"):
        return _mesh_search(packed, max_dist, strategy, metric=metric,
                            word_length=word_length, tile=tile,
                            runs_threshold=runs_threshold, join_cap=join_cap,
                            device=dev, mesh=mesh, info=info)
    if strategy == "runs" and metric == "edit":
        info["join_cap_fallbacks"] = 0
        try:
            return find_edit_pairs_shifted(
                packed, max_dist, word_length=word_length, join_cap=join_cap,
                device=dev, info=info, shard=shard)
        except JoinCapExceeded:
            if not auto_chosen:
                raise
            # Degenerate key space: dense is slower but always correct,
            # like the reference's own exhaustive walk.  (Under a shard the
            # cap is checked before ownership, so every part gets here.)
            info.update(strategy="dense", join_cap_fallbacks=1)
            strategy = "dense"
    if strategy == "bucketed":
        return find_neighbor_pairs_bucketed(
            packed, max_dist, word_length=word_length, tile=tile, device=dev,
            shard=shard, info=info)
    if strategy in ("runs", "runs_device"):
        if word_length is None:
            raise ValueError(f"{strategy} strategy requires word_length")
        if strategy == "runs":
            return find_neighbor_pairs_runs(
                packed, max_dist, word_length=word_length, tile=tile,
                device=dev, info=info, shard=shard)
        from .runs_device import runs_device_pairs

        return runs_device_pairs(packed, max_dist, word_length=word_length,
                                 tile=tile, device=dev, info=info,
                                 shard=shard)
    if strategy != "dense":
        raise ValueError(f"unknown strategy {strategy!r} for the {metric} "
                         f"metric")
    if metric == "edit":
        return dense_edit_pairs(packed, max_dist, word_length=word_length,
                                tile=tile, device=dev, shard=shard, info=info)
    rows, tile_pairs, b, u_pad = dense_inputs(packed, tile)
    tile_pairs = _stripe(tile_pairs, shard, b, info)
    if not len(tile_pairs):
        return _empty_pairs()
    return _tile_sweep(rows, tile_pairs, tile=b, u_pad=u_pad, u=u,
                       max_dist=max_dist, device=dev)


def _stripe(tile_pairs: np.ndarray, shard, tile: int, info: dict | None):
    """A part's stripe ``tile_pairs[part::n_parts]`` of a tile-pair list:
    each unordered pair lies in exactly one tile pair, so the stripes
    partition the pair set.  ``info`` receives the stripe's evaluations as
    "candidates"."""
    if shard is None:
        return tile_pairs
    tile_pairs = tile_pairs[shard[0]::shard[1]]
    if info is not None:
        info["candidates"] = len(tile_pairs) * tile * tile
    return tile_pairs


def dense_edit_pairs(packed: np.ndarray, max_dist: int, *, word_length: int,
                     tile: int = 2048,
                     device: str | torch.device | None = None,
                     shard: tuple[int, int] | None = None,
                     info: dict | None = None):
    """The dense edit scan: every upper-triangular tile pair of the table
    (tiles of at most 512 rows: a pair of tiles holds 2m + 1 band cells
    per word pair) through the banded-Levenshtein tile scan, or a shard's
    stripe of them.  The codes are unpacked once on the device; (a, b)
    int64 numpy, sorted."""
    dev = resolve_device(device)
    u = len(packed)
    rows, tile_pairs, b, _ = dense_inputs(packed, min(tile, 512))
    tile_pairs = _stripe(tile_pairs, _check_shard(shard), b, info)
    if not len(tile_pairs):
        return _empty_pairs()
    codes = E._unpack(lanes_tensor(rows, dev), word_length)
    a, bb = E.edit_tile_pairs(
        codes, codes, tile_pairs, tile=b, max_dist=max_dist,
        word_length=word_length, row_valid=u, col_valid=u, upper_only=True)
    a, bb = _sorted_pairs(a, bb, u)
    return a.cpu().numpy(), bb.cpu().numpy()


def _mesh_search(packed, max_dist, strategy, *, metric, word_length, tile,
                 runs_threshold, join_cap, device, mesh, info):
    """The mesh strategies of :func:`find_neighbor_pairs`."""
    from .. import parallel as P

    mesh = mesh or P.data_mesh(device=device)
    info.update(shards=len(mesh), ring_fallbacks=0)
    segments_apply = (max_dist >= 1 and word_length is not None
                      and len(packed) > runs_threshold)
    if metric == "edit":
        # Unshifted pigeonhole buckets do not bound edit distance, so the
        # bucketed mesh search cannot serve it, and the ring kernel
        # counts differing bases.
        if strategy == "sharded_bucketed":
            raise ValueError(
                "sharded_bucketed supports only the hamming metric "
                "(pigeonhole segments do not bound edit distance); "
                "use strategy='sharded'")
        if strategy == "ring":
            raise ValueError(f"ring strategy: unknown metric {metric!r}")
        # Subquadratic first: the (segment, shift) joins sharded over the
        # mesh; a degenerate key space goes to the dense edit ring.
        if segments_apply:
            info["join_cap_fallbacks"] = 0
            try:
                return P.sharded_edit_pairs_shifted(
                    packed, max_dist, word_length=word_length, mesh=mesh,
                    tile=tile, join_cap=join_cap, info=info)
            except JoinCapExceeded:
                info["join_cap_fallbacks"] = 1
        return P.sharded_neighbor_pairs(packed, max_dist, mesh=mesh,
                                        tile=tile, metric="edit",
                                        word_length=word_length)
    if strategy == "sharded_bucketed" or (strategy == "sharded"
                                          and segments_apply):
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


def _identity_runs(key: np.ndarray):
    """Run structure of an already sorted key array: partition 0's key is
    the word prefix and the unique table ascends, so its stable order is
    the identity and one compare pass replaces the sort.  The order is
    checked (a permuted table would lose pairs silently); an unsorted key
    takes :func:`_partition_runs`."""
    n = len(key)
    if not np.all(key[1:] >= key[:-1]):
        return _partition_runs(key)
    new_run = np.empty(n, bool)
    new_run[0] = True
    np.not_equal(key[1:], key[:-1], out=new_run[1:])
    run_start = np.flatnonzero(new_run)
    run_len = np.diff(np.append(run_start, n))
    return np.arange(n, dtype=np.int64), run_start, run_len


def _run_pairs_fallback(order, starts, lens):
    """In-run pairs without the host extension: every unordered pair of
    each run (sorted positions ``starts[r]`` .. ``+ lens[r]`` of
    ``order``) as (min, max) of their ``order`` entries, run by run in
    the row-major order of ``np.triu_indices`` (vectorized: each position
    pairs with the ones after it in its run)."""
    within = concat_aranges(lens)
    pos = np.repeat(np.asarray(starts, np.int64), lens) + within
    n_after = np.repeat(np.asarray(lens, np.int64), lens) - 1 - within
    left = np.repeat(pos, n_after)
    right = left + 1 + concat_aranges(n_after)
    a, b = order[left], order[right]
    return np.minimum(a, b), np.maximum(a, b)


def enumerate_run_pairs(packed, word64, order, starts, lens, max_dist):
    """In-run candidate enumeration + Hamming filter for the given
    equal-key runs: the fused native pass (enumerate, XOR, popcount) when
    the word fits 64 bits and the extension is built, the native
    enumeration and :func:`_filter_hamming_host` otherwise, numpy without
    the extension.  Returns (a, b, n_candidates), a < b, neither sorted
    nor deduplicated.  Shared by the host runs engine, the device runs
    engine's mid runs and the fused route, so their ladders agree."""
    t_cand = int((lens * (lens - 1) // 2).sum())
    if t_cand == 0:
        z = np.zeros(0, np.int64)
        return z, z, 0
    ss = np.ascontiguousarray(starts, np.int64)
    sl = np.ascontiguousarray(lens, np.int64)
    order = np.ascontiguousarray(order, np.int64)
    if word64 is not None and _run_pairs_hamming_native is not None:
        oa = np.empty(t_cand, np.int64)
        ob = np.empty(t_cand, np.int64)
        n_out = _run_pairs_hamming_native(word64, order, ss, sl,
                                          int(max_dist), oa, ob)
        return oa[:n_out].copy(), ob[:n_out].copy(), t_cand
    if _run_pairs_native is not None:
        oa = np.empty(t_cand, np.int64)
        ob = np.empty(t_cand, np.int64)
        n_out = _run_pairs_native(order, ss, sl, oa, ob)
        ca, cb = oa[:n_out], ob[:n_out]
    else:
        ca, cb = _run_pairs_fallback(order, ss, sl)
    a, b = _filter_hamming_host(packed, ca, cb, max_dist)
    return a, b, t_cand


def _popcount_u32(x: np.ndarray) -> np.ndarray:
    """SWAR population count of uint32 values (wrapping uint32 multiply)."""
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2))
                                       & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> np.uint32(24)


def _filter_hamming_host(packed, a, b, max_dist):
    """Keep the candidate pairs within ``max_dist`` differing bases
    (vectorized XOR, 2-bit collapse and popcount per lane)."""
    z = packed[a] ^ packed[b]
    m = (z | (z >> np.uint32(1))) & np.uint32(0x55555555)
    d = _popcount_u32(m).sum(axis=1, dtype=np.int64)
    keep = d <= max_dist
    return a[keep], b[keep]


def _combined_u64(packed):
    """[U, w <= 2] uint32 lanes -> contiguous uint64 words (the bit layout
    of :func:`_segment_run_ids`)."""
    word64 = packed[:, 0].astype(np.uint64) << np.uint64(32)
    if packed.shape[1] == 2:
        word64 |= packed[:, 1].astype(np.uint64)
    return np.ascontiguousarray(word64)


def find_neighbor_pairs_runs(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    run_cap: int = 2048,
    tile: int = 2048,
    device: str | torch.device | None = None,
    info: dict | None = None,
    shard: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pigeonhole neighbour search by sorted-run enumeration on the host.

    The guarantee of :func:`find_neighbor_pairs_bucketed` (a pair within
    Hamming distance m agrees exactly on one of m + 1 contiguous
    segments), but the equal-segment runs the sort produces are
    enumerated directly instead of sweeping the tiles around them: every
    in-run pair is a candidate, kept by XOR + popcount
    (:func:`enumerate_run_pairs`).  Expected candidates per partition are
    the real pairs plus ~U^2 / 4^(L/(m+1)) random collisions.

    Runs longer than ``run_cap`` (degenerate buckets, e.g. low-entropy
    reads) go to the Hamming tile sweep on ``device`` with its run-id
    mask, over only the tiles they span (:func:`_big_run_pairs`); when
    such runs cover more rows than the table has, one dense sweep finds
    every pair once instead.  ``info`` receives "candidates" and
    "dense_fallbacks".

    ``shard=(part, n_parts)`` keeps the runs this part owns (the salted
    hash of the run's key, salt = the partition): the part's candidates
    are ~1/n_parts of them.  The dense fallback is decided on the row
    count before ownership, so every part falls back together (and then
    sweeps its stripe).

    Replaces the reference's per-word fuzzy trie walk
    (findHammingNeighbours, humid.cc:113-130).
    """
    info = {} if info is None else info
    shard = _check_shard(shard)
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        info.update(candidates=0, dense_fallbacks=0)
        return _empty_pairs()
    n_seg = max_dist + 1
    keys = _segment_run_ids(packed, word_length, n_seg)
    word64 = _combined_u64(packed) if w <= 2 else None
    parts_a: list = [None] * n_seg
    parts_b: list = [None] * n_seg
    big_parts: list[tuple] = []
    big_rows = [0] * n_seg
    cand_stat = [0] * n_seg

    def _one_partition(p):
        # Partition 0 is in sorted order already (prefix key of the
        # ascending unique table): no sort.
        order, run_start, run_len = (
            _identity_runs(keys[0]) if p == 0 else _partition_runs(keys[p]))
        small = (run_len >= 2) & (run_len <= run_cap)
        big = run_len > run_cap
        # The fallback below must be decided alike on every part: the
        # row count before ownership.
        big_rows[p] = int(run_len[big].sum())
        if shard is not None:
            owned = _owned_mask(keys[p][order[run_start]], shard, salt_idx=p)
            small &= owned
            big &= owned
        parts_a[p], parts_b[p], cand_stat[p] = enumerate_run_pairs(
            packed, word64, order, run_start[small], run_len[small],
            max_dist)
        if big.any():
            big_parts.append((p, order, run_start[big], run_len[big]))

    # The native sort is parallel over every core already, so partitions
    # run one after another with it; the numpy fallback is single-threaded
    # per partition, and there a pool overlaps them.
    if _unique_u64 is None and n_seg > 1:
        with ThreadPoolExecutor(max_workers=n_seg) as ex:
            list(ex.map(_one_partition, range(n_seg)))
    else:
        for p in range(n_seg):
            _one_partition(p)
    info["candidates"] = sum(cand_stat)
    info["dense_fallbacks"] = int(sum(big_rows) > u)
    if sum(big_rows) > u:
        # Giant runs in several partitions (one template with scattered
        # substitutions): the stacked scan would meet every pair once per
        # partition; one dense sweep meets it once.
        return find_neighbor_pairs(packed, max_dist, word_length=word_length,
                                   tile=tile, strategy="dense", device=device,
                                   shard=shard)
    if big_parts:
        big_parts.sort(key=lambda part: part[0])
        ba, bb = _big_run_pairs(packed, big_parts, max_dist, tile=tile,
                                device=device)
        parts_a.append(ba)
        parts_b.append(bb)
    a = np.concatenate(parts_a)
    b = np.concatenate(parts_b)
    if not len(a):
        return _empty_pairs()
    return _dedupe_pairs(a, b)


def _big_run_pairs(packed, big_parts, max_dist, *, tile: int = 2048,
                   device=None):
    """The Hamming tile sweep (kernel K1) restricted to oversized runs.

    For each (partition, order, big run starts, big run lengths) the
    partition's permuted rows are stacked; only rows inside big runs get
    a matchable (non-negative) run id, every other row a distinct
    negative one, and only the tile pairs those runs span are swept, with
    the sweep's run-id mask (``hamming_tile_pairs(..., ids=)``).  Returns
    (a, b) unique-word indices, a < b, unsorted."""
    u, w = packed.shape
    b = min(tile, _round_up(u, 256))
    u_pad = _round_up(u, b)
    t = u_pad // b
    datas, rids, pair_lists, orders = [], [], [], []
    for pi, (_p, order, rs, rl) in enumerate(big_parts):
        dperm = np.zeros((u_pad, w), np.uint32)
        dperm[:u] = packed[order]
        rid = -np.arange(1, u_pad + 1, dtype=np.int64) - pi * (u_pad + 1)
        pairs = set()
        for k, (s, l) in enumerate(zip(rs.tolist(), rl.tolist())):
            rid[s:s + l] = k + pi * (u_pad + 1)
            t0, t1 = s // b, (s + l - 1) // b
            for i in range(t0, t1 + 1):
                for j in range(i, t1 + 1):
                    pairs.add((i, j))
        datas.append(dperm)
        rids.append(rid.astype(np.int32))
        pair_lists.append(np.array(sorted(pairs), np.int32).reshape(-1, 2)
                          + np.int32(pi * t))
        orders.append(order)
    dev = resolve_device(device)
    lanes, tp = sweep_tensors(np.concatenate(datas), np.concatenate(
        pair_lists), dev)
    ids = torch.from_numpy(np.concatenate(rids)).to(dev)
    pa, pb = hamming_tile_pairs(lanes, tp, tile=b, part_stride=u_pad,
                                part_valid=u, max_dist=max_dist, ids=ids)
    pa, pb = pa.cpu().numpy(), pb.cpu().numpy()
    # Stacked permuted positions -> unique-word indices, through each
    # partition's own order.
    ga = np.empty(len(pa), np.int64)
    gb = np.empty(len(pb), np.int64)
    for pi, order in enumerate(orders):
        sel = (pa // u_pad) == pi
        ga[sel] = order[pa[sel] % u_pad]
        sel = (pb // u_pad) == pi
        gb[sel] = order[pb[sel] % u_pad]
    return np.minimum(ga, gb), np.maximum(ga, gb)


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
    shard: tuple[int, int] | None = None,
    info: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Subquadratic Hamming neighbour pairs via pigeonhole partitions
    (:func:`bucketed_inputs`).  Words of other runs in the swept tiles
    are compared too; any pair the sweep finds is within ``max_dist``,
    and a pair found in several partitions is deduplicated at the end.

    Complexity per partition ~ O(U/tile) diagonal tiles plus extra tiles
    for runs crossing tile boundaries — versus O((U/tile)^2) dense.

    ``shard=(part, n_parts)`` sweeps the part's stripe of the stacked
    tile-pair list with the run-id mask on (each pair of a run lies in
    one tile pair of its partition, so the stripes partition each
    partition's in-run pairs, and no part sends another part's pairs
    across the gather).
    """
    if word_length is None:
        raise ValueError("bucketed strategy requires word_length")
    shard = _check_shard(shard)
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        # Unique words are pairwise distinct: no pairs at distance 0.
        return _empty_pairs()
    dev = resolve_device(device)
    rows, tile_pairs, b, u_pad, orders = bucketed_inputs(
        packed, max_dist, word_length, tile)
    ids = None
    if shard is not None:
        tile_pairs = _stripe(tile_pairs, shard, b, info)
        if not len(tile_pairs):
            return _empty_pairs()
        ids = _stacked_run_ids(rows, u, u_pad, word_length, max_dist + 1)
    pa, pb = _tile_sweep(rows, tile_pairs, tile=b, u_pad=u_pad, u=u,
                         max_dist=max_dist, device=dev, ids=ids)
    # Stacked permuted positions -> original unique-word indices.
    ga = orders[pa // u_pad, pa % u_pad]
    gb = orders[pb // u_pad, pb % u_pad]
    # A pair agreeing on k>1 segments appears k times; dedupe + sort.
    return _dedupe_pairs(np.minimum(ga, gb), np.maximum(ga, gb))


def _stacked_run_ids(rows: np.ndarray, u: int, u_pad: int, word_length: int,
                     n_seg: int) -> np.ndarray:
    """[n_seg * u_pad] int32 run ids of the bucketed engine's stacked rows
    (each partition sorted by its segment key): equal within a run of
    equal keys, distinct across runs and partitions; padding rows get -1
    (the sweep's validity test drops them anyway)."""
    from .runs_device import segment_lane_masks

    masks = segment_lane_masks(word_length, n_seg, rows.shape[1])
    ids = np.full(n_seg * u_pad, -1, np.int32)
    for p in range(n_seg):
        seg = rows[p * u_pad:p * u_pad + u] & masks[p]
        new = np.ones(u, bool)
        new[1:] = (seg[1:] != seg[:-1]).any(axis=1)
        ids[p * u_pad:p * u_pad + u] = np.cumsum(new) - 1 + p * (u_pad + 1)
    return ids


def _segment_keys_at(packed: np.ndarray, word_length: int, lo: int,
                     hi: int, codes: np.ndarray | None = None
                     ) -> np.ndarray:
    """[U] uint64 keys of the bases at positions [lo, hi) of every word
    (same bit layout as :func:`_segment_run_ids`).  ``codes`` (pre-unpacked
    [U, L]) avoids re-unpacking wide words on every (segment, shift)."""
    u, w = packed.shape
    width = 2 * (hi - lo)
    if w <= 2:
        word64 = packed[:, 0].astype(np.uint64) << np.uint64(32)
        if w == 2:
            word64 |= packed[:, 1].astype(np.uint64)
        return ((word64 >> np.uint64(64 - 2 * hi))
                & np.uint64((1 << width) - 1))
    if codes is None:
        codes = W.unpack_words(packed, word_length)
    k = np.zeros(u, np.uint64)
    for c in range(lo, hi):
        k = (k << np.uint64(2)) | codes[:, c].astype(np.uint64)
    return k


def _sorted_run_counts(sk: np.ndarray):
    """(values, counts) of a sorted uint64 array (no re-sort)."""
    if not len(sk):
        return sk, np.zeros(0, np.int64)
    new = np.empty(len(sk), bool)
    new[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    return sk[starts], np.diff(np.append(starts, len(sk)))


def _matching_runs(va: np.ndarray, vb: np.ndarray):
    """Runs of two sorted-unique key arrays that share a key: (ia, ib)
    with va[ia] == vb[ib]."""
    if not len(va):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pos = np.searchsorted(va, vb)
    pos_c = np.minimum(pos, len(va) - 1)
    ib = np.flatnonzero((pos < len(va)) & (va[pos_c] == vb))
    return pos[ib], ib


def _join_size(ka_sorted: np.ndarray, kb_sorted: np.ndarray,
               self_join: bool) -> int:
    """Equal-key join output size from the sorted key arrays alone: the
    unordered in-run pairs of a self join, else the sum of the run
    products (a word that meets itself is still counted)."""
    ua, ca = _sorted_run_counts(ka_sorted)
    if self_join:
        return int((ca * (ca - 1) // 2).sum())
    ub, cb = _sorted_run_counts(kb_sorted)
    ia, ib = _matching_runs(ua, ub)
    return int((ca[ia] * cb[ib]).sum())


def _merge_join_numpy(ka_sorted: np.ndarray, oa: np.ndarray,
                      kb_sorted: np.ndarray, ob: np.ndarray,
                      self_join: bool):
    """The equal-key merge join in numpy (the host extension's
    ``merge_join_pairs`` when that is not built): for every key both
    sorted views hold, the cross product of its rows in ``oa`` and in
    ``ob``, as (min, max) with self pairs dropped; a self join (both
    views the same) emits each unordered pair once.  The pair set equals
    the native join's; the order differs, and the caller dedupes."""
    va, ca = _sorted_run_counts(ka_sorted)
    sa = np.cumsum(ca) - ca
    if self_join:
        # The in-run pairs of the runs engine's fallback; ``oa`` is a
        # permutation, so no row meets itself.
        return _run_pairs_fallback(oa, sa, ca)
    vb, cb = _sorted_run_counts(kb_sorted)
    sb = np.cumsum(cb) - cb
    ia, ib = _matching_runs(va, vb)
    # Every row of a matched A run pairs with the whole B run.
    rows_a = np.repeat(sa[ia], ca[ia]) + concat_aranges(ca[ia])
    n_b = np.repeat(cb[ib], ca[ia])
    left = np.repeat(rows_a, n_b)
    right = np.repeat(np.repeat(sb[ib], ca[ia]), n_b) + concat_aranges(n_b)
    a, b = oa[left], ob[right]
    keep = a != b
    a, b = a[keep], b[keep]
    return np.minimum(a, b), np.maximum(a, b)


def _join_need(ka_sorted, kb_sorted, self_join: bool, join_cap: int,
               where: str) -> int:
    """A join's output size from its sorted keys; raises
    :class:`JoinCapExceeded` above ``join_cap``."""
    need = _join_size(ka_sorted, kb_sorted, self_join)
    if need > join_cap:
        raise JoinCapExceeded(
            f"shifted-segment join for {where} needs {need} candidate "
            f"pairs (> join_cap={join_cap}); the key space is degenerate "
            f"- use strategy='dense' (CLI: {STRATEGY_ENV_VAR}=dense)")
    return need


def _merge_join(ka, oa, kb, ob, self_join: bool, join_cap: int, where: str):
    """One (segment, shift) join: candidate pairs (a, b), a < b, of the
    rows whose keys ``ka[oa]`` and ``kb[ob]`` (``oa``/``ob`` sort them)
    are equal.  The output size is reckoned from the run lengths first,
    so :class:`JoinCapExceeded` is raised before anything is allocated."""
    ka_sorted = ka[oa]
    kb_sorted = ka_sorted if self_join else kb[ob]
    need = _join_need(ka_sorted, kb_sorted, self_join, join_cap, where)
    if _merge_join_native is None:
        return _merge_join_numpy(ka_sorted, oa, kb_sorted, ob, self_join)
    outa = np.empty(need, np.int64)
    outb = np.empty(need, np.int64)
    n = _merge_join_native(
        np.ascontiguousarray(ka), np.ascontiguousarray(oa),
        np.ascontiguousarray(kb), np.ascontiguousarray(ob),
        int(self_join), outa, outb)
    if n < 0:
        raise RuntimeError(f"merge join for {where} produced {-n} pairs, "
                           f"more than the {need} its run lengths allow")
    return outa[:n], outb[:n]


def default_join_cap() -> int:
    """A quarter of the host's available memory at 16 bytes a pair, at
    least 2^26 pairs."""
    return max(1 << 26, avail_bytes() // 4 // 16)


def shifted_joins(packed: np.ndarray, max_dist: int, word_length: int):
    """The (segment, shift) joins of the shifted-segment searches: yields
    (s, d, ka, oa, kb, ob) per join — the canonical keys of segment s and
    the order that sorts them, and the keys of the same segment read d
    bases further right with theirs (the very same arrays when d == 0, a
    self join)."""
    u = len(packed)
    n_seg = max_dist + 1
    bounds = [word_length * s // n_seg for s in range(n_seg + 1)]
    codes = (W.unpack_words(packed, word_length) if packed.shape[1] > 2
             else None)
    for s in range(n_seg):
        lo, hi = bounds[s], bounds[s + 1]
        ka = _segment_keys_at(packed, word_length, lo, hi, codes)
        # Segment 0's canonical key is the word prefix: identity order
        # (verified - a permuted table would silently lose pairs).
        oa = (np.arange(u, dtype=np.int64)
              if s == 0 and np.all(ka[1:] >= ka[:-1])
              else _stable_argsort_u64(ka))
        for d in range(-max_dist, max_dist + 1):
            if lo + d < 0 or hi + d > word_length:
                continue
            if d == 0:
                yield s, d, ka, oa, ka, oa
            else:
                kb = _segment_keys_at(packed, word_length, lo + d, hi + d,
                                      codes)
                yield s, d, ka, oa, kb, _stable_argsort_u64(kb)


def find_edit_pairs_shifted(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    join_cap: int | None = None,
    device: str | torch.device | None = None,
    info: dict | None = None,
    shard: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Subquadratic Levenshtein neighbour pairs via shifted segments.

    Partition lemma with indels: in an alignment with <= m edits over
    m + 1 contiguous query segments, at least one segment is untouched, so
    it appears exactly in the partner word at its own position offset by
    the indel balance d in [-m, m].  For every (segment, shift) the
    equal-key pairs of (segment value at canonical position) x (segment
    value at shifted position) are candidates, generated by a sorted
    merge join on the host and verified with the banded Levenshtein DP
    on ``device`` (:func:`.edit.edit_pairs_verify`).  Candidates ~ real
    pairs + (m+1)(2m+1) * U^2/4^(L/(m+1)) random collisions: subquadratic
    for typical word lengths, replacing the dense O(U^2) edit scan (findEditNeighbours,
    humid.cc:140-158).

    A join whose output would exceed ``join_cap`` (degenerate key space,
    e.g. all words sharing a segment) raises :class:`JoinCapExceeded`.

    ``shard=(part, n_parts)`` keeps the join keys this part owns (salt:
    the (segment, shift) index): equal keys have one owner, so each
    candidate comes from one part per join.  The cap is checked on the
    whole join first, so every part raises together."""
    shard = _check_shard(shard)
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        return _empty_pairs()
    if join_cap is None:
        join_cap = default_join_cap()
    info = {} if info is None else info
    parts_a, parts_b = [], []
    for s, d, ka, oa, kb, ob in shifted_joins(packed, max_dist, word_length):
        where = f"(segment {s}, shift {d})"
        if shard is not None:
            ka_sorted = ka[oa]
            _join_need(ka_sorted, ka_sorted if d == 0 else kb[ob], d == 0,
                       join_cap, where)
            salt = s * (2 * max_dist + 1) + d + max_dist
            oa = oa[_owned_mask(ka, shard, salt)[oa]]
            ob = oa if d == 0 else ob[_owned_mask(kb, shard, salt)[ob]]
        a, b = _merge_join(ka, oa, kb, ob, d == 0, join_cap, where)
        parts_a.append(a)
        parts_b.append(b)
    a = np.concatenate(parts_a)
    b = np.concatenate(parts_b)
    info["candidates"] = len(a)
    if not len(a):
        return _empty_pairs()
    a, b = _dedupe_pairs(a, b)
    return E.edit_pairs_verify(packed, a, b, max_dist, word_length,
                               device=device)


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
