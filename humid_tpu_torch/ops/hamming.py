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
word does not matter to a count.  This is the form the CUDA kernels
compute (``csrc/hamming_common.cuh``); the plain versions of the kernels
keep the first form.

Lanes are carried as int64 tensors holding the uint32 value (0..2^32-1):
most torch ops lack uint32, and with int64 the right shift is logical for
these non-negative values.  :func:`lanes_u32` converts the int32 views of
the same bits that the kernel wrappers take.
"""

from __future__ import annotations

import numpy as np
import torch

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
