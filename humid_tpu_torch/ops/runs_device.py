"""Device pigeonhole runs engine: in-run candidate evaluation on the card.

The host ``runs`` engine (:func:`.neighbors.find_neighbor_pairs_runs`)
replaces the reference's fuzzy trie walk (findHammingNeighbours,
humid.cc:113-130) with sorted-run enumeration: sort the unique words by
each of the ``max_dist + 1`` contiguous segment keys and compare only the
pairs inside a run of equal keys.  This module evaluates the same
candidates on the device.  After sorting by a segment key, every in-run
pair is a pair of sorted positions (i, i + d) with d <= run length - 1,
and (i, i + d) lie in one run exactly when the segment bits of
rows[i] XOR rows[i + d] are all zero, a test on the very XOR the distance
needs.  So for each offset d in 1..d_max the program XORs the table with
its d-shifted self, tests in-run-ness and distance, and returns the
matches as packed bitmaps (one bit a row: 8x smaller than bool on the way
to the host).  d_max adapts to the run lengths; longer runs are
enumerated on the host while the sweeps run, and runs longer than
``run_cap`` take the Hamming tile sweep with its run-id mask, as in the
host engine.  These steps run in the fused route's
:class:`.fused.FusedPipeline`, which also sorts the partitions on the
device; :func:`runs_device_pairs` enters it with the unique table.

Counterpart of ``humid_tpu/ops/runs_device.py``; its ``_runs_eval`` is a
``jax.jit`` program, here a sequence of PyTorch ops on int32 lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .hamming import MASK_LO, popcount32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def segment_lane_masks(word_length: int, n_seg: int, w: int) -> np.ndarray:
    """[n_seg, w] uint32: the bits of each pigeonhole segment in each lane.

    Lane l of a packed word holds bases 16l..16l+15, base b at bits
    30-2*(b % 16) .. 31-2*(b % 16) (big-endian within the lane, the layout
    of words.pack_words and of ``_segment_run_ids``' 64-bit words).
    """
    bounds = [word_length * s // n_seg for s in range(n_seg + 1)]
    masks = np.zeros((n_seg, w), np.uint32)
    for s in range(n_seg):
        for b in range(bounds[s], bounds[s + 1]):
            lane, pos = divmod(b, 16)
            masks[s, lane] |= np.uint32(0b11 << (30 - 2 * pos))
    return masks


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """[..., N] bool (N % 8 == 0) -> [..., N/8] uint8, bit k of byte j set
    by flags[..., 8j + k]: the bytes of little-endian uint32 bitmap words
    in which bit k of word j stands for row 32j + k."""
    shifts = torch.arange(8, dtype=torch.uint8, device=flags.device)
    by = flags.reshape(*flags.shape[:-1], -1, 8).to(torch.uint8)
    return (by << shifts).sum(dim=-1, dtype=torch.uint8)


def _runs_eval(lanes: torch.Tensor, orders: torch.Tensor | None,
               seg_masks: torch.Tensor, n_valid: int, max_dist: int, *,
               d_hi: int, d_lo: int = 1, with_matches: bool = False,
               owned: torch.Tensor | None = None):
    """Offset-shift in-run Hamming evaluation (the fused route's program C
    too).

    lanes: [N, w] int32, N % 32 == 0 — the unique table in its ascending
      order (partition 0's segment key is the word prefix, so its sorted
      order is the identity and the table is used as it is); rows
      >= ``n_valid`` are padding.
    orders: [n_seg - 1, N] int64 sorted orders of partitions 1..m (the
      device gathers the permuted rows itself), or None when n_seg == 1.
    seg_masks: [n_seg, w] int32 segment bit masks (:func:`segment_lane_masks`).
    owned: optional [n_seg, N] bool by table row: whether this host shard
      owns the row's run in partition p (:func:`.neighbors._owned_mask`
      of its segment key, which every member of a run shares); a pair is
      kept only where its first member's run is owned.

    Returns (bitmaps, matches): bitmaps [n_seg, d_hi - d_lo + 1, N/8]
    uint8 (:func:`pack_bits`), bit i of (p, d - d_lo) set iff sorted
    positions (i, i + d) of partition p are an in-run pair within
    ``max_dist``; matches, the same as bool [n_seg, nd, N] when
    ``with_matches``, else None.  No host synchronisation.

    The 2-bit collapse (z | z >> 1) & 0x55555555 is exact on int32: the
    shift is arithmetic, but the mask clears bit 31, and bit 30 of z >> 1
    is bit 31 of z either way.  The collapsed lanes hold even bits only,
    so two of them share one popcount (the second shifted left by one).
    """
    n, w = lanes.shape
    n_seg = seg_masks.shape[0]
    nd = d_hi - d_lo + 1
    dev = lanes.device
    matches = torch.zeros((n_seg, nd, n), dtype=torch.bool, device=dev)
    iota = torch.arange(n, device=dev)
    for p in range(n_seg):
        r = lanes if p == 0 else lanes[orders[p - 1]]
        own = None
        if owned is not None:
            own = owned[p] if p == 0 else owned[p][orders[p - 1]]
        mask_p = seg_masks[p]
        for d in range(d_lo, d_hi + 1):
            if d >= n:
                continue
            z = r[:n - d] ^ r[d:]
            in_run = ((z & mask_p) == 0).all(dim=1)
            m = ((z | (z >> 1)) & MASK_LO).to(torch.int64)
            pair = m[:, 0::2].clone()
            pair[:, :w // 2] |= m[:, 1::2] << 1
            dist = popcount32(pair).sum(dim=1)
            hit = in_run & (dist <= max_dist) & (iota[:n - d] < n_valid - d)
            if own is not None:
                hit &= own[:n - d]
            matches[p, d - d_lo, :n - d] = hit
    return pack_bits(matches), (matches if with_matches else None)


def _bitmap_positions(bits: np.ndarray, n: int) -> np.ndarray:
    """Packed bitmap (uint8 bytes, or the little-endian uint32 words they
    make) -> sorted positions (< n) of its set bits."""
    by = np.ascontiguousarray(bits).view(np.uint8)
    return np.flatnonzero(np.unpackbits(by, bitorder="little")[:n])


def runs_device_pairs(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    d_cap: int = 8,
    run_cap: int = 2048,
    tile: int = 2048,
    device: str | torch.device | None = None,
    info: dict | None = None,
    shard: tuple[int, int] | None = None,
    impl: str | None = None,
    cap_total: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pigeonhole neighbour search with the partitions and the in-run
    pairs evaluated on ``device``.

    The output and guarantee of
    :func:`.neighbors.find_neighbor_pairs_runs` (every unordered pair
    within ``max_dist`` once, sorted).  The engine is the fused route past
    unique counting (:meth:`.fused.FusedPipeline.from_table`): the table
    goes up once, the device sorts partitions 1..m (partition 0's order is
    the identity: the table ascends and its key is the prefix) and sweeps
    the runs of up to d_max + 1 rows (:func:`_runs_eval`); runs of
    (d_max + 1, run_cap] rows are enumerated on the host while the sweeps
    run (d_max, a power of two up to ``d_cap``, grows until they hold
    under 2% of the table); runs longer than ``run_cap`` take the big-run
    tile sweep, and giant runs the dense sweep, both by ``impl`` with the
    first capacity ``cap_total`` (:func:`.neighbors.sweep`).  ``info``
    receives "candidates", "dense_fallbacks", "d_max" and "decode".

    ``shard=(part, n_parts)`` keeps the runs this part owns, by the host
    engine's rule: the ownership of each row's run is hashed here from
    the segment keys and goes up with the table (program C masks the
    sweeps with it, the host the mid and big runs).  The depth, the
    decode and the dense fallback are decided before ownership, alike on
    every part; "candidates" counts the runs before ownership.
    """
    from .fused import FusedPipeline
    from .neighbors import (_check_shard, _empty_pairs, _owned_mask,
                            _segment_run_ids, find_neighbor_pairs_runs)

    info = {} if info is None else info
    shard = _check_shard(shard)
    if len(packed) <= 1 or max_dist == 0:
        info.update(candidates=0, dense_fallbacks=0, d_max=0)
        return _empty_pairs()
    dev = resolve_device(device)
    keys = _segment_run_ids(packed, word_length, max_dist + 1)
    key0 = keys[0]
    if not np.all(key0[1:] >= key0[:-1]):
        # The sweep takes partition 0 in the table's own order; a table
        # that does not ascend (outside the contract) goes to the host
        # engine, which sorts every partition, rather than lose pairs.
        return find_neighbor_pairs_runs(packed, max_dist,
                                        word_length=word_length,
                                        run_cap=run_cap, tile=tile,
                                        device=dev, info=info, shard=shard,
                                        impl=impl, cap_total=cap_total)
    owned = None
    if shard is not None:
        owned = np.stack([_owned_mask(k, shard, salt_idx=p)
                          for p, k in enumerate(keys)])
    fp = FusedPipeline.from_table(packed, word_length=word_length,
                                  max_dist=max_dist, device=dev, d_cap=d_cap,
                                  run_cap=run_cap, tile=tile, shard=shard,
                                  owned=owned, impl=impl,
                                  cap_total=cap_total)
    got: dict = {}
    pairs = fp.neighbors(info=got)
    info.update({k: got[k] for k in ("candidates", "dense_fallbacks", "d_max",
                                     "decode")})
    return pairs
