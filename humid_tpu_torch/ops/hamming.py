"""Plain PyTorch statement of the Hamming metric over 2-bit packed words.

A word of L bases is packed into w = ceil(L/16) uint32 lanes, 16 bases per
lane, base p of a lane at bits 2*(15-p) (:mod:`humid_tpu_torch.words`).
The number of differing bases of two words is

  mismatches(a, b) = sum over lanes of
                     popcount(((a ^ b) | ((a ^ b) >> 1)) & 0x55555555)

— each 2-bit base group contributes 1 iff the bases differ.  Unused low
bits of the last lane are zero in every word, so they never differ.

The same count needs one popcount per 32 bases when each word is first
split into bit planes (:func:`planes`): of two neighbouring lanes A, B,

  lo = (A & 0x55555555) | ((B & 0x55555555) << 1)
  hi = ((A >> 1) & 0x55555555) | (B & 0xAAAAAAAA)

so that every base owns one bit, at the same position in ``lo`` (the low
bit of its code) and in ``hi`` (the high bit), and

  mismatches(a, b) = sum over lane pairs of
                     popcount((lo_a ^ lo_b) | (hi_a ^ hi_b))

(:func:`mismatch_counts_planes`).  The order of the bases inside a plane
word does not matter to a count.  This is the POPC form, which the
earlier builds that ``tools/k1_compare.py`` and ``tools/k2_compare.py``
time the kernels against compute (the kernels themselves read the
simplex encoding of ``ops/simplex_encode.py``); the plain versions of the
kernels keep the first form.

Lanes are carried as int64 tensors holding the uint32 value (0..2^32-1):
most torch ops lack uint32, and with int64 the right shift is logical for
these non-negative values.  :func:`lanes_u32` converts the int32 views of
the same bits that the kernel wrappers take.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

MASK_LO = 0x55555555
MASK_HI = 0xAAAAAAAA


def lanes_tensor(packed: np.ndarray, device: torch.device) -> torch.Tensor:
    """[N, w] uint32 lanes (numpy) -> the int32 tensor of the same bits on
    ``device``, the form the kernel wrappers and the edit programs take."""
    return torch.from_numpy(
        np.ascontiguousarray(packed, np.uint32).view(np.int32)).to(device)


def lanes_u32(lanes: torch.Tensor) -> torch.Tensor:
    """int32 (bit view of uint32) or int64 lanes -> int64 holding the
    unsigned 32-bit value."""
    return lanes.to(torch.int64) & 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of int64 tensors holding 32-bit values
    (torch has no popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def mismatch_counts(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[R, w] x [C, w] int64 lanes (uint32 values) -> [R, C] int64
    per-base mismatch counts."""
    d = torch.zeros((rows.shape[0], cols.shape[0]), dtype=torch.int64,
                    device=rows.device)
    for lane in range(rows.shape[1]):
        z = rows[:, lane, None] ^ cols[None, :, lane]
        d += popcount32((z | (z >> 1)) & MASK_LO)
    return d


def planes(lanes: torch.Tensor) -> torch.Tensor:
    """[N, w] lanes (int64 uint32 values, or the int32 bit views) ->
    [N, 2 * ceil(w / 2)] int64 bit planes, (lo, hi) per pair of lanes:
    plane words 2p and 2p + 1 hold the low and the high code bits of the
    32 bases of lanes 2p and 2p + 1.  For odd w the last pair's second
    lane is zero, so the upper half of its planes is empty."""
    lanes = lanes_u32(lanes)  # int32 views: mask before any shift
    n, w = lanes.shape
    if w % 2:
        lanes = torch.cat([lanes, lanes.new_zeros((n, 1))], dim=1)
    a, b = lanes[:, 0::2], lanes[:, 1::2]
    lo = (a & MASK_LO) | ((b & MASK_LO) << 1)
    hi = ((a >> 1) & MASK_LO) | (b & MASK_HI)
    return torch.stack([lo, hi], dim=2).reshape(n, -1)


def mismatch_counts_planes(rows: torch.Tensor,
                           cols: torch.Tensor) -> torch.Tensor:
    """:func:`mismatch_counts` through the bit planes: one popcount per
    pair of lanes (32 bases)."""
    pr, pc = planes(rows), planes(cols)
    d = torch.zeros((pr.shape[0], pc.shape[0]), dtype=torch.int64,
                    device=pr.device)
    for k in range(0, pr.shape[1], 2):
        lo = pr[:, k, None] ^ pc[None, :, k]
        hi = pr[:, k + 1, None] ^ pc[None, :, k + 1]
        d += popcount32(lo | hi)
    return d


# --- The reference's block functions and the one-hot matrix-product form ---
#
# The number of MATCHING bases of two words is the dot product of their
# one-hot encodings (4 columns a base, one of them 1), so
#
#   mismatches(a, b) = L - <onehot(a), onehot(b)>
#
# and a whole block of distances is one matrix product.  This is the
# reference's ``impl="mxu"`` (``humid_tpu/ops/hamming.py``,
# ``ops/neighbors.py::onehot_bases``); here it is a PyTorch matrix
# product, not a kernel of this package.

#: Longest word the one-hot form takes: a bf16 product holds integers
#: exactly only up to 256 (8 significant bits), and a match count is at
#: most L.  The reference states the same bound
#: (``humid_tpu/ops/neighbors.py:115``); here a longer word raises.
ONEHOT_MAX_L = 256
#: Entries of one [rows, cols] match matrix of the one-hot route.
ONEHOT_ELEMS = 1 << 28


def onehot_dtype(device: torch.device) -> torch.dtype:
    """The one-hot products' type on ``device``: bf16 on a card, as the
    reference computes them (exact for L <= :data:`ONEHOT_MAX_L`), float32
    on the CPU (exact to 2^24)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _as_lanes(words, device) -> torch.Tensor:
    """[N, w] uint32 numpy words, or lanes as a tensor, -> int64 lanes
    holding the uint32 values.  Numpy goes to the device every entry
    point takes (:func:`.._device.resolve_device`: ``device``, else
    $HUMID_TPU_TORCH_DEVICE, else the card); a tensor stays on its own
    device unless ``device`` is given."""
    if isinstance(words, np.ndarray):
        words = lanes_tensor(words, resolve_device(device))
    elif device is not None:
        words = words.to(resolve_device(device))
    return lanes_u32(words)


def base_codes(lanes: torch.Tensor) -> torch.Tensor:
    """[N, w] lanes (int32 bit views or int64 uint32 values) -> [N, 16 w]
    base codes 0-3 (A C G T) of the lanes' integer type, base p of lane l
    in column 16 l + p: all 16 slots of every lane, the padding slots past
    a word's length included (code 0 in every word).  An int32 view is
    shifted as it is (the mask keeps the two bits an arithmetic shift
    leaves right), at half the bytes of int64."""
    v = lanes if lanes.dtype == torch.int32 else lanes_u32(lanes)
    n, w = v.shape
    shifts = 2 * (15 - torch.arange(16, dtype=v.dtype, device=v.device))
    return ((v[:, :, None] >> shifts) & 3).reshape(n, 16 * w)


def onehot_bases(lanes: torch.Tensor, word_length: int, *,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[N, w] lanes -> [N, D] one-hot encoding of the first
    ``word_length`` bases (4 columns a base, in code order A C G T), D =
    4L zero-padded up to a multiple of 32 (the padding adds nothing to a
    product)."""
    n, w = lanes.shape
    if not 1 <= word_length <= 16 * w:
        raise ValueError(f"word_length {word_length} outside [1, {16 * w}] "
                         f"for {w} lanes")
    codes = base_codes(lanes)[:, :word_length]
    oh = codes[:, :, None] == torch.arange(4, device=lanes.device)
    out = torch.zeros((n, -(-4 * word_length // 32) * 32), dtype=dtype,
                      device=lanes.device)
    out[:, :4 * word_length] = oh.reshape(n, 4 * word_length)
    return out


def onehot_bands(a: torch.Tensor, b: torch.Tensor):
    """The row bands of the product ``a`` x ``b``^T that the route computes
    one at a time, each of at most :data:`ONEHOT_ELEMS` entries: a list of
    (first row, the band of ``a``)."""
    band = max(1, ONEHOT_ELEMS // max(len(b), 1))
    return [(r0, a[r0:r0 + band]) for r0 in range(0, len(a), band)]


def pad_rows(x: torch.Tensor, multiple: int = 32) -> torch.Tensor:
    """``x`` with zero rows appended up to a multiple of ``multiple`` (``x``
    itself, not a copy, when it has such a count already)."""
    if not len(x) % multiple:
        return x
    return torch.cat([x, x.new_zeros((-len(x) % multiple, x.shape[1]))])


def onehot_products(a: torch.Tensor, b: torch.Tensor):
    """The route's matrix products of ``a`` x ``b``^T ([R, D] x [C, D]
    encodings), one band at a time (:func:`onehot_bands`): yields (first
    row, the band's match counts).  ``b`` is zero-padded to a multiple of
    32 rows first: on an H100 a product with an odd column count (44,699
    at one ring step of the 1M sample) took 2.8x as long (PERF.md);
    columns from C on are that padding."""
    b = pad_rows(b)
    for r0, band in onehot_bands(a, b):
        yield r0, band @ b.t()


def _check_onehot_length(word_length) -> None:
    if word_length is None:
        raise ValueError("the one-hot (mxu) route requires word_length")
    if not 1 <= word_length <= ONEHOT_MAX_L:
        raise ValueError(f"the one-hot (mxu) route is exact only for words "
                         f"of at most {ONEHOT_MAX_L} bases, got "
                         f"{word_length}")


def _onehot_hits(a, b, thr: int):
    """(ri, ci) int64 of the entries of ``a`` x ``b``^T ([R, D] x [C, D]
    encodings) with at least ``thr`` matching bases, in row-major order
    (:func:`onehot_products`)."""
    hits = [torch.zeros((0, 2), dtype=torch.int64, device=a.device)]
    for r0, matches in onehot_products(a, b):
        hits.append((matches >= thr).nonzero())
        hits[-1][:, 0] += r0
    hits = torch.cat(hits)
    hits = hits[hits[:, 1] < len(b)]
    return hits[:, 0], hits[:, 1]


def onehot_tile_blocks(oh: torch.Tensor, tile_pairs: np.ndarray, tile: int):
    """The one-hot route's operands for the listed tile pairs (``tile_pairs``
    [P, 2 or 3] numpy, (ti, tj) first, every row swept) over the
    encoding ``oh``: per row
    tile, its rows against the rows of the column tiles listed with it,
    at most :data:`ONEHOT_ELEMS` entries a block.  Yields (first row, the
    rows' encoding, the columns' global indices, their encoding); for
    consecutive column tiles (every dense row tile) the encodings are
    views."""
    n_rows = len(oh)
    for ti in np.unique(tile_pairs[:, 0]).tolist():
        r0, r1 = ti * tile, min((ti + 1) * tile, n_rows)
        col_tiles = tile_pairs[tile_pairs[:, 0] == ti, 1].tolist()
        per = max(1, ONEHOT_ELEMS // ((r1 - r0) * tile))
        for lo in range(0, len(col_tiles), per):
            tjs = col_tiles[lo:lo + per]
            c0, c1 = tjs[0] * tile, min((tjs[-1] + 1) * tile, n_rows)
            if tjs == list(range(tjs[0], tjs[-1] + 1)):
                cidx = torch.arange(c0, max(c0, c1), device=oh.device)
                yield r0, oh[r0:r1], cidx, oh[c0:c1]
            else:
                cidx = torch.from_numpy(np.concatenate([
                    np.arange(tj * tile, min((tj + 1) * tile, n_rows))
                    for tj in tjs])).to(oh.device)
                yield r0, oh[r0:r1], cidx, oh[cidx]


class _KeyBuffer:
    """Pair keys collected on the device: a buffer of ``cap`` keys at
    first, grown (doubled, or to the need) when a chunk's hits do not
    fit."""

    def __init__(self, cap: int, device):
        self.keys = torch.empty(max(int(cap), 1), dtype=torch.int64,
                                device=device)
        self.n = 0

    def append(self, k: torch.Tensor) -> None:
        need = self.n + len(k)
        if need > len(self.keys):
            grown = torch.empty(max(need, 2 * len(self.keys)),
                                dtype=torch.int64, device=self.keys.device)
            grown[:self.n] = self.keys[:self.n]
            self.keys = grown
        self.keys[self.n:need] = k
        self.n = need


def onehot_tile_pairs(lanes: torch.Tensor, tile_pairs: torch.Tensor, *,
                      tile: int, part_stride: int, part_valid: int,
                      max_dist: int, word_length: int,
                      ids: torch.Tensor | None = None,
                      cap_total: int | None = None):
    """The tile sweep's function (the contract of
    :func:`.cuda_hamming.hamming_tile_pairs`) by one-hot matrix products
    of :func:`onehot_dtype`'s type (:func:`onehot_tile_blocks`),
    ``matches >= L - max_dist``, a compaction of the hits, then the
    validity, upper-triangle and run-id tests on the (few) hits.  Off the
    diagonal every column lies above every row, so "b > a" is the
    upper-triangle test of every tile pair.  ``cap_total`` is the first
    capacity (pairs) of the key buffer (default: K1's ``CAP_START``).
    Exact for ``word_length <= ONEHOT_MAX_L``.  Returns (a, b) int64 on
    the input's device, sorted by (a, b)."""
    from .cuda_hamming import CAP_START, _BAD_TILE_PAIR, _check, _sorted_keys

    _check(lanes, tile_pairs, tile, part_stride, part_valid, max_dist, ids)
    _check_onehot_length(word_length)
    dev = lanes.device
    n_rows = lanes.shape[0]
    oh = onehot_bases(lanes, word_length, dtype=onehot_dtype(dev))
    tp = tile_pairs.cpu().numpy()
    if len(tp) and ((tp[:, 0] < 0) | (tp[:, 1] < tp[:, 0])).any():
        raise ValueError(_BAD_TILE_PAIR)
    tp = tp[(tp[:, 2] != 0) & (tp[:, 0] * tile < n_rows)]
    out = _KeyBuffer(CAP_START if cap_total is None else cap_total, dev)
    for r0, a, cidx, b in onehot_tile_blocks(oh, tp, tile):
        ri, ci = _onehot_hits(a, b, word_length - max_dist)
        ga, gb = r0 + ri, cidx[ci]
        keep = ((gb > ga) & (ga % part_stride < part_valid)
                & (gb % part_stride < part_valid))
        if ids is not None:
            keep &= ids[ga] == ids[gb]
        out.append(ga[keep] * n_rows + gb[keep])
    return _sorted_keys(out.keys[:out.n], n_rows)


def _block_result(ri, ci, row_off: int, col_off: int, cap: int):
    """Hits of a block -> the reference's block output: (r_idx, c_idx)
    [cap] int32 global indices in row-major order, padded with -1, and
    the true count (above ``cap`` on overflow)."""
    dev = ri.device
    count = torch.tensor(len(ri), dtype=torch.int32, device=dev)
    r_idx = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    c_idx = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    k = min(cap, len(ri))
    r_idx[:k] = (ri[:k] + row_off).to(torch.int32)
    c_idx[:k] = (ci[:k] + col_off).to(torch.int32)
    return r_idx, c_idx, count


def hamming_block_xor(rows, cols, row_off: int, col_off: int, max_dist: int,
                      cap: int, *, device=None):
    """Upper-triangle neighbour pairs between a row block and a column
    block, by XOR + popcount (the reference's ``hamming_block_xor``).

    ``rows`` [R, w] are global rows row_off..row_off+R, ``cols`` [C, w]
    global columns col_off..; either uint32 numpy words or lane tensors,
    computed on ``device`` (numpy: as every entry point resolves it, the
    card by default; a tensor: its own device by default).  Only pairs
    with global column > global row count.  Returns (r_idx, c_idx) [cap]
    int32 global indices, row-major, padded with -1, and the true number
    of matches (0-d int32; above ``cap`` on overflow)."""
    vr, vc = _as_lanes(rows, device), _as_lanes(cols, device)
    gr = row_off + torch.arange(vr.shape[0], device=vr.device)
    gc = col_off + torch.arange(vc.shape[0], device=vr.device)
    mask = ((mismatch_counts(vr, vc) <= max_dist)
            & (gc[None, :] > gr[:, None]))
    ri, ci = mask.nonzero(as_tuple=True)
    return _block_result(ri, ci, row_off, col_off, cap)


def hamming_block_mxu(rows, cols, row_off: int, col_off: int, max_dist: int,
                      cap: int, word_length: int, *, device=None):
    """:func:`hamming_block_xor` by one-hot matrix products of
    :func:`onehot_dtype`'s type (the reference's ``hamming_block_mxu``):
    exact for ``word_length <= ONEHOT_MAX_L``."""
    _check_onehot_length(word_length)
    vr, vc = _as_lanes(rows, device), _as_lanes(cols, device)
    dtype = onehot_dtype(vr.device)
    ri, ci = _onehot_hits(onehot_bases(vr, word_length, dtype=dtype),
                          onehot_bases(vc, word_length, dtype=dtype),
                          word_length - max_dist)
    keep = (col_off + ci) > (row_off + ri)
    return _block_result(ri[keep], ci[keep], row_off, col_off, cap)
