"""Hamming tile sweep: the CUDA kernel's wrapper, its plain PyTorch
version, and the kernel's launch counter.

Counterpart of ``humid_tpu/ops/pallas_hamming.py`` (the TPU kernel
``_kernel`` launched by ``pallas_all_pairs``, whose per-row top-k output
``_extract_with_retry`` compacts into pairs).  The kernel itself is
``humid_tpu_torch/csrc/hamming_sweep.cu``; its source note says what
bounds it on the card.

Contract of :func:`hamming_tile_pairs` and :func:`hamming_tile_pairs_plain`:

* ``lanes`` — [N, w] int32 tensor holding the uint32 bits of the packed
  words (``torch.from_numpy(packed.view(np.int32))``): 16 bases per lane,
  base p at bits 2*(15-p).
* ``tile_pairs`` — [nb, 3] int32 tensor of (ti, tj, on) on the same
  device, 0 <= ti <= tj (anything else raises ``ValueError``).  Tile ti
  covers rows [ti*tile, (ti+1)*tile).  Tile pairs with on == 0 emit
  nothing.
* A row index g is valid when g < N and g % part_stride < part_valid.
* ``ids`` — optional [N] int32 run ids on the same device: with it a pair
  is emitted only when ids[a] == ids[b] (the run-id mask of the
  pigeonhole engines, ``row_ids``/``col_ids`` of the reference's tile
  scan).  ``None`` means no mask.
* Returns every (a, b) with a in tile ti, b in tile tj, both valid, at
  most ``max_dist`` differing bases, and b > a on diagonal tile pairs, as
  two int64 tensors on the input's device, sorted by (a, b).  Then a < b.

On a CUDA tensor :func:`hamming_tile_pairs` launches the kernel or raises;
on a CPU tensor, and only there, it runs the plain version in its place.

The kernel computes every distance on the int8 tensor cores from an
encoded table that the wrapper builds once per call (``simplex_encode``:
its CUDA pre-pass :func:`encode`, whose plain version is
:func:`encode_table`): 3 channels of +-1 a base, so that the integer
product of two words' rows is 48 w - 4 * distance, and a pair passes iff
that product reaches :func:`pass_threshold`.  It writes one int64 key
``a * N + b`` per match, so the sort runs on what the kernel wrote, and
it tests the tile pairs itself: a launch costs the host one read
(:func:`_read_back`: the match count, which decides a relaunch, and the
bad-tile-pair flag, together) and no other synchronisation.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..phaselog import no_span
from .hamming import lanes_u32, mismatch_counts
from .simplex_encode import (  # noqa: F401 (the encoding's names here too)
    SIMPLEX, TABLE_ROWS, encode, encode_table, pass_threshold, table_width)

#: Kernel launches in this process (one per launch of the CUDA kernel,
#: nowhere else); callers reset it to 0 to count one run's launches.
LAUNCHES = 0

#: Tile pairs per launch.  Bounds one launch's match count, and so its
#: buffer (the kernel itself takes any number: its work list is one grid
#: dimension).
CHUNK_PAIRS = 4096
#: First pair-buffer capacity of a launch (pairs); a launch whose counter
#: exceeds it is relaunched once with the exact count.
CAP_START = 1 << 23
#: Largest buffer one launch may take; a chunk with more matches than this
#: is split in two instead.
MAX_CAP = 1 << 27
#: Lane counts the kernel is instantiated for (words up to 256 bases).
MAX_LANES = 16


def _check(lanes: torch.Tensor, tile_pairs: torch.Tensor, tile: int,
           part_stride: int, part_valid: int, max_dist: int,
           ids: torch.Tensor | None = None) -> None:
    if lanes.dtype != torch.int32 or lanes.dim() != 2:
        raise ValueError(f"lanes must be a 2-D int32 tensor, got "
                         f"{lanes.dtype} {tuple(lanes.shape)}")
    if not lanes.is_contiguous():
        raise ValueError("lanes must be contiguous")
    if (tile_pairs.dtype != torch.int32 or tile_pairs.dim() != 2
            or tile_pairs.shape[1] != 3):
        raise ValueError(f"tile_pairs must be an [nb, 3] int32 tensor, got "
                         f"{tile_pairs.dtype} {tuple(tile_pairs.shape)}")
    if not tile_pairs.is_contiguous():
        raise ValueError("tile_pairs must be contiguous")
    if tile_pairs.device != lanes.device:
        raise ValueError(f"tile_pairs on {tile_pairs.device}, lanes on "
                         f"{lanes.device}")
    if lanes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lanes.device}")
    if ids is not None and (
            ids.dtype != torch.int32 or ids.shape != lanes.shape[:1]
            or ids.device != lanes.device or not ids.is_contiguous()):
        raise ValueError(f"ids must be a contiguous [{lanes.shape[0]}] int32 "
                         f"tensor on {lanes.device}, got {ids.dtype} "
                         f"{tuple(ids.shape)} on {ids.device}")
    if tile <= 0 or part_stride <= 0 or part_valid < 0 or max_dist < 0:
        raise ValueError(f"bad sweep parameters tile={tile} "
                         f"part_stride={part_stride} "
                         f"part_valid={part_valid} max_dist={max_dist}")
    if lanes.shape[0] >= 1 << 31:
        raise ValueError(f"{lanes.shape[0]} rows: pair keys need N < 2^31")


_BAD_TILE_PAIR = "tile_pairs must have 0 <= ti <= tj"


def _sorted_keys(keys: torch.Tensor, n_rows: int):
    """int64 keys a * n_rows + b -> (a, b) sorted by (a, b)."""
    key = torch.sort(keys).values
    a = key // n_rows
    return a, key - a * n_rows


def _sorted_pairs(a: torch.Tensor, b: torch.Tensor, n_rows: int):
    """Sort (a, b) lexicographically through one int64 key."""
    return _sorted_keys(a * n_rows + b, n_rows)


def hamming_tile_pairs_plain(lanes: torch.Tensor, tile_pairs: torch.Tensor,
                             *, tile: int, part_stride: int, part_valid: int,
                             max_dist: int, ids: torch.Tensor | None = None):
    """Plain PyTorch version of the sweep (same contract as
    :func:`hamming_tile_pairs`), on any device: one dense [tile, tile]
    distance matrix per tile pair."""
    _check(lanes, tile_pairs, tile, part_stride, part_valid, max_dist, ids)
    n_rows = lanes.shape[0]
    dev = lanes.device
    vals = lanes_u32(lanes)
    outs_a, outs_b = [], []
    for ti, tj, on in tile_pairs.tolist():
        if ti < 0 or tj < ti:
            raise ValueError(_BAD_TILE_PAIR)
        r0, c0 = ti * tile, tj * tile
        if not on or r0 >= n_rows or c0 >= n_rows:
            continue
        r1, c1 = min(r0 + tile, n_rows), min(c0 + tile, n_rows)
        gr = torch.arange(r0, r1, device=dev)
        gc = torch.arange(c0, c1, device=dev)
        mask = mismatch_counts(vals[r0:r1], vals[c0:c1]) <= max_dist
        mask &= (gr % part_stride < part_valid)[:, None]
        mask &= (gc % part_stride < part_valid)[None, :]
        if ti == tj:
            mask &= gc[None, :] > gr[:, None]
        if ids is not None:
            mask &= ids[r0:r1, None] == ids[None, c0:c1]
        ri, ci = mask.nonzero(as_tuple=True)
        outs_a.append(gr[ri])
        outs_b.append(gc[ci])
    if not outs_a:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty.clone()
    return _sorted_pairs(torch.cat(outs_a), torch.cat(outs_b), n_rows)


@functools.cache
def _kernel_fn():
    from .. import _build

    fn = _build.load("hamming_sweep").humid_hamming_sweep
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, i64, i32, i64, i32, p, p, i64, i32, i64, i64, i32, p,
                   i64, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(lanes, pairs, keys, counter, *, tile, part_stride, part_valid,
            max_dist, ids=None, table=None) -> None:
    """Enqueue the kernel over ``pairs`` on the current stream: matching
    keys go to ``keys`` (as many as it holds), their number is added to
    ``counter[0]``, and ``counter[1]`` is set if a tile pair is negative
    or out of order.  ``table`` is the encoded table of ``lanes``
    (:func:`encode`, built here when not given).  No host
    synchronisation."""
    global LAUNCHES
    n, w = lanes.shape
    if w > MAX_LANES:
        raise ValueError(f"the CUDA sweep takes at most {MAX_LANES} lanes "
                         f"(256-base words), got {w}")
    if table is None:
        table = encode(lanes)
    # The launch's work counter: the kernel's CTAs take their units from it.
    work = torch.zeros(1, dtype=torch.int64, device=lanes.device)
    with torch.cuda.device(lanes.device):
        err = _kernel_fn()(
            table.data_ptr(), table.shape[0], table.shape[1], n, w,
            None if ids is None else ids.data_ptr(), pairs.data_ptr(),
            len(pairs), tile, part_stride, part_valid,
            pass_threshold(w, max_dist), keys.data_ptr(), len(keys),
            counter.data_ptr(), work.data_ptr(),
            torch.cuda.current_stream(lanes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hamming_sweep launch failed: CUDA error {err}")
    LAUNCHES += 1


def _read_back(counter: torch.Tensor) -> list[int]:
    """The one host read of a launch: the counter words through pinned
    memory, after the current stream has drained."""
    host = torch.empty(counter.shape, dtype=counter.dtype, pin_memory=True)
    host.copy_(counter, non_blocking=True)
    torch.cuda.current_stream(counter.device).synchronize()
    return host.tolist()


def _sweep(lanes, pairs, cap, span=no_span, **kw):
    """One pass over ``pairs`` into a fresh [cap] key buffer -> (keys, true
    match count).  The kernel on CUDA tensors; on CPU tensors the plain
    version fills the buffer the way the kernel would.  The host's wait
    for the result (the read-back, or the plain version) is the span
    "wait K1"."""
    dev = lanes.device
    keys = torch.empty(cap, dtype=torch.int64, device=dev)
    if dev.type == "cpu":
        with span("wait K1"):
            a, b = hamming_tile_pairs_plain(lanes, pairs, **kw)
        k = min(cap, len(a))
        keys[:k] = a[:k] * lanes.shape[0] + b[:k]
        return keys, len(a)
    counter = torch.zeros(2, dtype=torch.int64, device=dev)
    _launch(lanes, pairs, keys, counter, **kw)
    with span("wait K1"):
        n, bad = _read_back(counter)
    if bad:
        raise ValueError(_BAD_TILE_PAIR)
    return keys, n


def _sweep_chunk(lanes, pairs, outs, cap_start, span=no_span,
                 **kw) -> None:
    """Sweep one chunk of tile pairs into a buffer of ``cap_start`` keys
    (fewer where the chunk cannot fill it), appending its keys to
    ``outs``: relaunch once with the exact capacity when the buffer
    overflowed, or split the chunk when that capacity would exceed
    MAX_CAP."""
    cap = max(1, min(cap_start, len(pairs) * kw["tile"] ** 2))
    keys, n = _sweep(lanes, pairs, cap, span=span, **kw)
    if n > cap:
        if n > MAX_CAP and len(pairs) > 1:
            half = len(pairs) // 2
            _sweep_chunk(lanes, pairs[:half], outs, cap_start, span=span,
                         **kw)
            _sweep_chunk(lanes, pairs[half:], outs, cap_start, span=span,
                         **kw)
            return
        keys, n = _sweep(lanes, pairs, n, span=span, **kw)
    # A slice would keep the whole buffer (CAP_START keys) alive: 2^23
    # uniques make 2,049 chunks, 128 GiB of buffers.
    outs.append(keys[:n].clone() if n < len(keys) else keys)


def hamming_tile_pairs(lanes: torch.Tensor, tile_pairs: torch.Tensor, *,
                       tile: int, part_stride: int, part_valid: int,
                       max_dist: int, ids: torch.Tensor | None = None,
                       cap_start: int | None = None, span=None):
    """All matching (a, b) of the tile-pair list (module docstring),
    int64, sorted by (a, b).  CUDA tensors run the hand-written kernel
    (``csrc/hamming_sweep.cu``) over one encoded table of ``lanes``
    (:func:`encode`, the CUDA pre-pass) in chunks of CHUNK_PAIRS tile
    pairs, each
    launch into a key buffer of ``cap_start`` pairs at first (default
    CAP_START; an overflow costs one relaunch, never a pair); CPU tensors
    run :func:`hamming_tile_pairs_plain` through the same buffers.
    ``span`` (a :meth:`..phaselog.PhaseLog.spans_under` callable; None
    times nothing) names the waits for each launch ("wait K1") and the
    sort ("pairs")."""
    _check(lanes, tile_pairs, tile, part_stride, part_valid, max_dist, ids)
    span = span or no_span
    kw = dict(tile=tile, part_stride=part_stride, part_valid=part_valid,
              max_dist=max_dist, ids=ids)
    if lanes.device.type == "cuda" and len(tile_pairs):
        kw["table"] = encode(lanes)  # once for every launch
    cap_start = CAP_START if cap_start is None else int(cap_start)
    outs: list = []
    for lo in range(0, len(tile_pairs), CHUNK_PAIRS):
        _sweep_chunk(lanes, tile_pairs[lo:lo + CHUNK_PAIRS], outs,
                     cap_start, span=span, **kw)
    if not outs:
        empty = torch.zeros(0, dtype=torch.int64, device=lanes.device)
        return empty, empty.clone()
    with span("pairs"):
        return _sorted_keys(outs[0] if len(outs) == 1 else torch.cat(outs),
                            lanes.shape[0])
