"""Exact-duplicate counting over packed word fingerprints, on the host
(a radix sort) or on the device (:func:`unique_words_device`).

Replaces the reference's trie insertion + leaf counts (humid.cc:92-99,
trie.add at humid.cc:95).  The trie's lexicographic ``walk()`` order
(humid.cc:117,178) is reproduced for free: unique fingerprints are returned
in ascending lane-lexicographic order, which equals lexicographic word
order because :func:`humid_tpu_torch.words.pack_words` packs big-endian.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import resolve_device, to_host
from .hamming import lanes_tensor

#: "host" or "device" pins the engine of :func:`unique_words`.
UNIQUE_ENV_VAR = "HUMID_TPU_TORCH_UNIQUE"
#: Rows above which :func:`unique_words` asks the router for the engine.
DEVICE_MIN_ROWS = 1 << 16

try:
    from .._hostops import argsort_u64 as _argsort_u64
    from .._hostops import unique_u64 as _unique_u64
    from .._hostops import unique_packed as _unique_packed
except ImportError:  # pragma: no cover - extension not built
    _argsort_u64 = None
    _unique_u64 = None
    _unique_packed = None


def _unique_packed_native(packed: np.ndarray, want_inverse: bool):
    """Fully fused native path: key build + stable radix sort + group
    structure all in C (csrc/hostops.cpp unique_packed)."""
    n, w = packed.shape
    packed = np.ascontiguousarray(packed)
    uniq = np.empty((n, w), np.uint32)
    counts = np.empty(n, np.int64)
    first_occ = np.empty(n, np.int64)
    inverse = np.empty(n if want_inverse else 1, np.int64)
    k = _unique_packed(packed, w, uniq, counts, first_occ, inverse,
                       int(want_inverse))
    return (uniq[:k].copy(), counts[:k].copy(), first_occ[:k].copy(),
            inverse if want_inverse else None)


def _unique_by_key_native(packed: np.ndarray, key: np.ndarray,
                          want_inverse: bool = True):
    """Fused native sort + group structure (csrc/hostops.cpp)."""
    n = len(key)
    order = np.empty(n, np.int64)
    group_start = np.empty(n, np.int64)
    counts = np.empty(n, np.int64)
    first_occ = np.empty(n, np.int64)
    inverse = np.empty(n if want_inverse else 1, np.int64)
    k = _unique_u64(np.ascontiguousarray(key), order, group_start,
                    counts, first_occ, inverse, int(want_inverse))
    uniq = packed[order[group_start[:k]]]
    return (uniq, counts[:k].copy(), first_occ[:k].copy(),
            inverse if want_inverse else None)


def _stable_argsort_u64(key: np.ndarray) -> np.ndarray:
    if _argsort_u64 is not None:
        order = np.empty(len(key), np.int64)
        _argsort_u64(np.ascontiguousarray(key), order)
        return order
    return np.argsort(key, kind="stable")


def unique_engine(n: int, device=None) -> str:
    """The engine :func:`unique_words` takes for ``n`` rows: ``device`` when
    $HUMID_TPU_TORCH_UNIQUE is "device", ``host`` when it is "host";
    otherwise, above DEVICE_MIN_ROWS rows with a ``device`` given, the
    router's measured choice for that device
    (:func:`humid_tpu_torch._backend.use_device_engine`), else ``host``."""
    env = os.environ.get(UNIQUE_ENV_VAR)
    if env in ("host", "device"):
        return env
    if device is None or n <= DEVICE_MIN_ROWS:
        return "host"
    from .._backend import use_device_engine

    return ("device" if use_device_engine("unique", resolve_device(device),
                                          n) else "host")


def unique_words(packed: np.ndarray, want_inverse: bool = True,
                 device=None, info: dict | None = None):
    """Group identical fingerprints.

    Args:
      packed: [N, W] uint32 fingerprint lanes (unfiltered words only).
      want_inverse: skip building the [N] row->unique map when the
        caller doesn't need per-read labels (dedup-only runs).
      device: where the device engine would run (:func:`unique_engine`
        decides whether it does); None keeps the host engine unless
        $HUMID_TPU_TORCH_UNIQUE is "device".
      info: if given, receives "unique": the engine that ran.

    Returns:
      uniq:       [U, W] uint32, ascending lexicographic order.
      counts:     [U]   int64 exact-duplicate count per unique word
                  (== trie leaf ``count``).
      first_occ:  [U]   int64 index (into the N input rows) of the first
                  occurrence of each unique word in input order — the
                  representative the dedup writer emits (humid.cc:224-231).
      inverse:    [N]   int64 mapping row -> unique index (None when
                  ``want_inverse`` is False).
    """
    n, w = packed.shape
    engine = unique_engine(n, device)
    if info is not None:
        info["unique"] = engine
    if engine == "device":
        return unique_words_device(packed, want_inverse, device)
    if n == 0:
        return _empty(w, want_inverse)
    # Stable sort in lane-lexicographic order.  For <= 2 lanes a single
    # uint64 key suffices, and the fused native path does sort + group
    # structure + inverse in one call.
    if w <= 2 and _unique_packed is not None and n <= np.iinfo(np.int32).max:
        return _unique_packed_native(packed, want_inverse)
    if w <= 2 and _unique_u64 is not None:
        if w == 1:
            key = packed[:, 0].astype(np.uint64)
        else:
            key = (packed[:, 0].astype(np.uint64) << np.uint64(32)) | \
                packed[:, 1].astype(np.uint64)
        return _unique_by_key_native(packed, key, want_inverse)
    if w == 1:
        order = _stable_argsort_u64(packed[:, 0].astype(np.uint64))
    elif w == 2:
        key = (packed[:, 0].astype(np.uint64) << np.uint64(32)) | \
            packed[:, 1].astype(np.uint64)
        order = _stable_argsort_u64(key)
    elif w <= 4 and _argsort_u64 is not None:
        # 3-4 lanes (word length 33-64): LSD two-pass over u64 halves
        # through the native radix sort — sort by the low half, then
        # stable-sort that order by the high half.
        def _half(lo_lane: int) -> np.ndarray:
            k = packed[:, lo_lane].astype(np.uint64) << np.uint64(32)
            if lo_lane + 1 < w:
                k |= packed[:, lo_lane + 1].astype(np.uint64)
            return k
        order = _stable_argsort_u64(_half(2))
        order = order[_stable_argsort_u64(_half(0)[order])]
    else:
        # Least-significant key last in np.lexsort's tuple.
        order = np.lexsort(tuple(packed[:, w - 1 - i] for i in range(w)))
    s = packed[order]
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    new_group[1:] = (s[1:] != s[:-1]).any(axis=1)
    group_start = np.flatnonzero(new_group)
    uniq = s[group_start]
    counts = np.diff(np.append(group_start, n)).astype(np.int64)
    # The sort is stable -> within a group original indices ascend, so the
    # group's first sorted element is the first occurrence in input order.
    first_occ = order[group_start].astype(np.int64)
    if want_inverse:
        gid = np.cumsum(new_group) - 1
        inverse = np.empty(n, dtype=np.int64)
        inverse[order] = gid
    else:
        inverse = None
    return uniq, counts, first_occ, inverse


def _empty(w: int, want_inverse: bool):
    return (np.zeros((0, w), np.uint32), np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64) if want_inverse else None)


_SIGN32 = -(1 << 31)


def _sort_keys(lanes: torch.Tensor, cols) -> list[torch.Tensor]:
    """int64 sort keys of the int32 lanes ``cols`` (bit views of uint32),
    two lanes a key, most significant first.  A key's signed order is its
    lanes' unsigned lexicographic order: the first lane gets its sign bit
    flipped and is scaled by 2^32 (no overflow), the second is added as
    its unsigned value; a lone lane is its unsigned value."""
    keys = []
    for i in range(0, len(cols), 2):
        if i + 1 < len(cols):
            hi = (lanes[:, cols[i]] ^ _SIGN32).to(torch.int64) * (1 << 32)
            keys.append(hi + (lanes[:, cols[i + 1]].to(torch.int64)
                              & 0xFFFFFFFF))
        else:
            keys.append(lanes[:, cols[i]].to(torch.int64) & 0xFFFFFFFF)
    return keys


def _lex_order(lanes: torch.Tensor, cols=None) -> torch.Tensor:
    """Stable order of the rows of ``lanes`` ([N, w] int32) in ascending
    unsigned lexicographic order of the lanes ``cols`` (default all):
    stable sorts of the int64 keys, least significant key first."""
    keys = _sort_keys(lanes, list(range(lanes.shape[1])) if cols is None
                      else list(cols))
    order = torch.sort(keys[-1], stable=True).indices
    for key in reversed(keys[:-1]):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _unique_program(lanes: torch.Tensor, n: int, want_inverse: bool):
    """Device unique counting over rows [0, n) of ``lanes`` ([cap, w]
    int32, n >= 1; rows >= n are padding of all ones).

    One stable lexicographic sort of all cap rows: padding has the largest
    key and the largest indices, so it sorts after every real row (a real
    all-T word included) and the first n sorted rows are the real ones:
    cutting there fences the padding off.  Group starts by comparing
    neighbours, group ids by a cumulative sum, counts by an index add,
    first occurrences by a scatter-min of the sorted original indices
    (stable: a group's smallest index is its first occurrence), the
    inverse by a scatter.  Every count and index is int64.  No host
    synchronisation.

    Returns (uniq [cap, w] int32: rows < k the unique words ascending,
    the rest all ones; counts [n] int64; first [n] int64; inverse [n]
    int64 or None; k as a 0-dim int64 tensor); rows >= k of counts and
    first are not used."""
    cap, w = lanes.shape
    dev = lanes.device
    order = _lex_order(lanes)[:n]
    sk = lanes[order]
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = (sk[1:] != sk[:-1]).any(dim=1)
    gid = torch.cumsum(new, dim=0) - 1
    counts = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, gid, torch.ones_like(gid))
    first = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, gid, order, "amin")
    uniq = torch.full((cap, w), -1, dtype=torch.int32, device=dev)
    uniq[gid] = sk
    inverse = (torch.empty(n, dtype=torch.int64, device=dev).scatter_(
        0, order, gid) if want_inverse else None)
    return uniq, counts, first, inverse, gid[-1] + 1


def unique_words_device(packed: np.ndarray, want_inverse: bool = True,
                        device=None):
    """:func:`unique_words` on ``device`` (same contract and results): the
    table goes up once, :func:`_unique_program` runs there, and the host
    waits twice, for k and for the one bundled read-back."""
    n, w = packed.shape
    if n == 0:
        return _empty(w, want_inverse)
    lanes = lanes_tensor(packed, resolve_device(device))
    uniq, counts, first, inverse, k = _unique_program(lanes, n, want_inverse)
    k = int(k)
    got = to_host(uniq[:k], counts[:k], first[:k],
                  *([inverse] if want_inverse else []))
    return (got[0].view(np.uint32), got[1], got[2],
            got[3] if want_inverse else None)
