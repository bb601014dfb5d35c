"""Banded Levenshtein distance on tensors (the ``-e`` flag).

Replaces ``trie.asymmetricLevenshtein`` (humid.cc:140-158).  Counterpart of
``humid_tpu/ops/edit.py``.  All words have the same length L, so the edit
distance uses an Ukkonen band of width 2m + 1 around the main diagonal: a
cell outside the band already exceeds the threshold m.  Band coordinate k
of DP row i stands for column j = i + k - m.

These are PyTorch programs, not hand-written kernels: every DP row is a
handful of elementwise operations over the whole [band, ...] state, which
lives in one tensor, and a caller batches many tile pairs (or candidate
pairs) into one pass so that the number of launches does not grow with
the table.  Distances are clamped at m + 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from .._util import avail_bytes
from ..phaselog import no_span
from .hamming import lanes_tensor

#: Bytes one evaluated pair occupies during the DP, per band cell: the
#: state, the next state and one scratch tensor (int32 each) and the
#: mismatch flags (bool); rounded up to leave room for the gathered codes.
_BYTES_PER_CELL = 16


def _unpack(lanes: torch.Tensor, word_length: int) -> torch.Tensor:
    """[N, w] int32 lanes (the uint32 bits) -> [N, L] int32 2-bit codes.

    ``>>`` on int32 is arithmetic, so a lane with its top bit set drags
    ones in from the left; ``& 3`` keeps the two bits that were shifted
    down to the bottom, which are the base's own for every shift used
    here, 30 included (bits 31:30 land on 1:0)."""
    n, w = lanes.shape
    shifts = 2 * (15 - torch.arange(16, dtype=torch.int32,
                                    device=lanes.device))
    codes = (lanes.unsqueeze(-1) >> shifts) & 3
    return codes.reshape(n, w * 16)[:, :word_length]


def _band_dp(a_rows: torch.Tensor, wins: torch.Tensor, shape: tuple,
             max_dist: int, word_length: int) -> torch.Tensor:
    """The banded DP over every element of ``shape`` at once.

    ``a_rows[i - 1]`` is base i of the first word and ``wins[i]`` [band,
    ...] holds, at band coordinate k, base j = i + k - m of the second
    word (-1 outside it); both broadcast to ``shape``.  Returns D[L][L]
    clamped at m + 1, int32 of ``shape``.

    Per row: one compare and one add (diagonal), an add and a minimum
    (up), one clamp, and an add and a minimum per band cell (left, a
    chain inside the row) — 4 (m + 1) + 1 launches whatever the shape."""
    m, L = max_dist, word_length
    band = 2 * m + 1
    inf = m + 1
    dev = a_rows.device
    # Row 0: D[0][j] = j for j in [0, m], else beyond the threshold; made
    # on the device, since a tensor built from a list is a blocking copy.
    j0 = torch.arange(-m, m + 1, dtype=torch.int32, device=dev)
    state = torch.where(j0 < 0, inf, j0).to(torch.int32).reshape(
        (band,) + (1,) * len(shape)).expand((band, *shape)).contiguous()
    cur = torch.empty_like(state)
    tmp = torch.empty_like(state)
    differ = torch.empty(state.shape, dtype=torch.bool, device=dev)
    for i in range(1, L + 1):
        torch.ne(a_rows[i - 1], wins[i], out=differ)
        torch.add(state, differ, out=cur)            # D[i-1][j-1] + sub
        if band > 1:
            torch.add(state[1:], 1, out=tmp[1:])     # D[i-1][j] + 1
            torch.minimum(cur[:-1], tmp[1:], out=cur[:-1])
        cur.clamp_(max=inf)
        for k in range(band):
            j = i + k - m
            if j == 0:
                cur[k].fill_(min(i, inf))            # D[i][0] = i
            elif j < 0 or j > L:
                cur[k].fill_(inf)
            elif k:
                torch.add(cur[k - 1], 1, out=tmp[k])  # D[i][j-1] + 1
                torch.minimum(cur[k], tmp[k], out=cur[k])
        state, cur = cur, state
    return state[m]


def _windows(b_codes: torch.Tensor, max_dist: int) -> torch.Tensor:
    """[..., C, L] codes -> [L + 1, band, ..., C]: entry [i, k] is base
    j = i + k - m of every word (1-based; -1 where the word has no such
    base).  One ``unfold`` of the padded codes, made contiguous once."""
    m = max_dist
    bpad = F.pad(b_codes, (m + 1, m), value=-1)       # [..., C, L + band]
    return bpad.unfold(-1, 2 * m + 1, 1).movedim((-2, -1), (0, 1)).contiguous()


def _banded_levenshtein(a_codes: torch.Tensor, b_codes: torch.Tensor,
                        max_dist: int, word_length: int) -> torch.Tensor:
    """[R, L] x [C, L] -> [R, C] int32 edit distances clamped at
    ``max_dist + 1``; with a leading batch dimension, [T, R, L] x
    [T, C, L] -> [T, R, C] (tile pair t compares a[t] with b[t])."""
    shape = (*a_codes.shape[:-2], a_codes.shape[-2], b_codes.shape[-2])
    a_rows = a_codes.movedim(-1, 0).unsqueeze(-1).contiguous()  # [L,..,R,1]
    wins = _windows(b_codes, max_dist).unsqueeze(-2)    # [L+1,band,..,1,C]
    return _band_dp(a_rows, wins, shape, max_dist, word_length)


def _banded_levenshtein_pairs(a_codes: torch.Tensor, b_codes: torch.Tensor,
                              max_dist: int, word_length: int) -> torch.Tensor:
    """[N, L] x [N, L] -> [N] int32 edit distances clamped at
    ``max_dist + 1``: pair n compares a[n] with b[n]."""
    a_rows = a_codes.movedim(-1, 0).contiguous()        # [L, N]
    return _band_dp(a_rows, _windows(b_codes, max_dist),
                    (a_codes.shape[0],), max_dist, word_length)


def _wait(dev: torch.device) -> None:
    """The one place where :func:`edit_pairs_verify` waits for the card."""
    torch.cuda.current_stream(dev).synchronize()


def edit_pairs_verify(packed: np.ndarray, a: np.ndarray, b: np.ndarray,
                      max_dist: int, word_length: int, batch: int = 1 << 20,
                      device: str | torch.device | None = None, span=None,
                      info: dict | None = None):
    """Keep the candidate pairs (a[i], b[i]) within edit distance
    ``max_dist``, in their order (the contract of the host filter,
    csrc/hostops.cpp::edit_filter_pairs).

    The packed table goes to the device once; every batch of ``batch``
    pairs gathers its rows there, unpacks them and runs the pairwise DP.
    The keep flags of all batches land in one pinned buffer and the host
    waits for the device once, after the last batch.

    ``span`` (a span callable; None times nothing) opens "verify" (the
    table's upload, the pinning, and every batch's copies, gathers and
    DP launches) and "wait verify" (the host blocked on the device, and
    the keep flags read back).  ``info`` receives "verify_batches"."""
    n = len(a)
    if n == 0:
        return a, b
    span = span or no_span
    with span("verify"):
        dev = resolve_device(device)
        lanes = lanes_tensor(packed, dev)
        on_card = dev.type == "cuda"
        keep = torch.empty(n, dtype=torch.bool, pin_memory=on_card)
        ia = torch.from_numpy(np.ascontiguousarray(a, np.int64))
        ib = torch.from_numpy(np.ascontiguousarray(b, np.int64))
        if on_card:
            ia, ib = ia.pin_memory(), ib.pin_memory()
        for lo in range(0, n, batch):
            hi = min(n, lo + batch)
            codes_a = _unpack(lanes.index_select(
                0, ia[lo:hi].to(dev, non_blocking=True)), word_length)
            codes_b = _unpack(lanes.index_select(
                0, ib[lo:hi].to(dev, non_blocking=True)), word_length)
            dist = _banded_levenshtein_pairs(codes_a, codes_b, int(max_dist),
                                             word_length)
            keep[lo:hi].copy_(dist <= max_dist, non_blocking=True)
    if info is not None:
        info["verify_batches"] = -(-n // batch)
    with span("wait verify"):
        if on_card:
            _wait(dev)
        keep = keep.numpy()
    return a[keep], b[keep]


def edit_block(rows: torch.Tensor, cols: torch.Tensor, row_off: int,
               col_off: int, max_dist: int, cap: int, word_length: int):
    """Levenshtein block compare of [R, w] x [C, w] int32 lanes: the pairs
    within ``max_dist`` whose global column index (``col_off`` + c) exceeds
    their global row index (``row_off`` + r).  Returns (r_idx [cap], c_idx
    [cap], count): the first ``cap`` matches in row-major order as global
    int32 indices, -1 filled, and the true match count.  The oracle that
    the tests hold the dense scan and the shifted search against."""
    dist = _banded_levenshtein(_unpack(rows, word_length),
                               _unpack(cols, word_length), int(max_dist),
                               word_length)
    dev = rows.device
    gr = row_off + torch.arange(rows.shape[0], device=dev)[:, None]
    gc = col_off + torch.arange(cols.shape[0], device=dev)[None, :]
    mask = (dist <= max_dist) & (gc > gr)
    ri, ci = mask.nonzero(as_tuple=True)
    r_idx = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    c_idx = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    k = min(cap, len(ri))
    r_idx[:k] = (ri[:k] + row_off).to(torch.int32)
    c_idx[:k] = (ci[:k] + col_off).to(torch.int32)
    return r_idx, c_idx, mask.sum(dtype=torch.int32)


def tile_batch(device: torch.device, tile: int, max_dist: int) -> int:
    """Tile pairs one DP pass may hold: a quarter of the device's free
    memory (an eighth of the host's, at most 256 MiB, on the CPU) over
    the bytes one [tile, tile] pair of tiles occupies during the DP."""
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 4
    else:
        budget = min(avail_bytes() // 8, 1 << 28)
    per_pair = tile * tile * (2 * max_dist + 1) * _BYTES_PER_CELL
    return max(1, budget // per_pair)


def edit_tile_pairs(row_codes: torch.Tensor, col_codes: torch.Tensor,
                    tile_pairs: np.ndarray, *, tile: int, max_dist: int,
                    word_length: int, row_valid: int, col_valid: int,
                    upper_only: bool, row_ids: torch.Tensor | None = None,
                    col_ids: torch.Tensor | None = None):
    """The banded-Levenshtein tile scan: every (r, c) of the listed tile
    pairs (ti, tj) — row tile ti of ``row_codes`` [Nr, L] against column
    tile tj of ``col_codes`` [Nc, L], both whole numbers of tiles — with
    r < ``row_valid``, c < ``col_valid``, edit distance <= ``max_dist``,
    c > r when ``upper_only`` (both sides are then the same table), and
    equal ids where ids are given.  Returns (r, c) int64 on the codes'
    device, in no particular order.

    Tile pairs go through the DP in batches sized by :func:`tile_batch`;
    each batch's matches are compacted with ``nonzero`` on the device."""
    dev = row_codes.device
    m, L = int(max_dist), word_length
    row_tiles = row_codes.view(-1, tile, L)
    col_tiles = col_codes.view(-1, tile, L)
    tp = torch.from_numpy(np.ascontiguousarray(tile_pairs, np.int64)).to(dev)
    within = torch.arange(tile, device=dev)
    outs_r, outs_c = [], []
    step = tile_batch(dev, tile, m)
    for lo in range(0, len(tp), step):
        ti, tj = tp[lo:lo + step, 0], tp[lo:lo + step, 1]
        dist = _banded_levenshtein(row_tiles.index_select(0, ti),
                                   col_tiles.index_select(0, tj), m, L)
        lr = (ti[:, None] * tile + within)[:, :, None]      # [T, tile, 1]
        lc = (tj[:, None] * tile + within)[:, None, :]      # [T, 1, tile]
        mask = (dist <= m) & (lr < row_valid) & (lc < col_valid)
        if upper_only:
            mask &= lc > lr
        if row_ids is not None:
            mask &= row_ids[lr] == col_ids[lc]
        t, r, c = mask.nonzero(as_tuple=True)
        outs_r.append(ti[t] * tile + r)
        outs_c.append(tj[t] * tile + c)
    if not outs_r:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty.clone()
    return torch.cat(outs_r), torch.cat(outs_c)
