"""The card's least time for a Hamming tile sweep: a frozen copy of the
program's roofline arithmetic (``chip_smoke.py::roofline``, ``bound_ms``
and ``tools/k1_compare.py::tensor_core_bound``), kept here so that no
later change to the program changes the yardstick.

The work is counted from what the search must decide, not from how a
kernel does it: ``pairs`` word pairs of ``w`` 16-base lanes, the packed
table (``rows`` x ``w`` x 4 bytes) read once, and 8 bytes written for each
pair found.  Three formulations are bounded, each by the larger of its
operations over the rate of the unit that does them and its bytes over
the memory rate, and the least of the three is the roofline:

* POPC: one POPC per 32 bases a pair (``ceil(w / 2)``), at 16 a clock per
  SM, beside 3 other integer operations per POPC at 64 a clock per SM;
* int8 one-hot: 4 channels a base, ``4 x 16 w`` multiply-adds a pair, 2
  operations each, at the int8 tensor-core rate;
* int8 simplex: 3 channels a base, ``3 x 16 w`` multiply-adds a pair.

Peaks: one NVIDIA H100 SXM (data sheet, dense, 700 W): 1,979 TOP/s int8,
3.35 TB/s of HBM3, 132 SMs at a 1,980 MHz maximum SM clock.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1.979e15
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_HZ = 1.98e9


def popc_bound_s(pairs: int, w: int, n_bytes: int) -> float:
    plane_pairs = -(-w // 2)
    per_s = SMS * SM_HZ
    ops = max(pairs * plane_pairs / (16 * per_s),
              pairs * 3 * plane_pairs / (64 * per_s))
    return max(ops, n_bytes / HBM_BYTES_PER_S)


def tensor_core_bound_s(pairs: int, w: int, n_bytes: int,
                        channels: int) -> float:
    ops = pairs * channels * 16 * w * 2 / INT8_OPS_PER_S
    return max(ops, n_bytes / HBM_BYTES_PER_S)


def sweep_bytes(rows: int, w: int, found: int) -> int:
    return rows * w * 4 + 8 * found


def roofline_s(pairs: int, w: int, n_bytes: int) -> float:
    """The least of the three forms' bounds, in seconds."""
    return min(popc_bound_s(pairs, w, n_bytes),
               tensor_core_bound_s(pairs, w, n_bytes, 4),
               tensor_core_bound_s(pairs, w, n_bytes, 3))


def dense_sweep_roofline_s(unique: int, w: int, found: int) -> float:
    """The dense sweep over ``unique`` words: every one of the
    ``unique (unique - 1) / 2`` pairs decided."""
    return roofline_s(unique * (unique - 1) // 2, w,
                      sweep_bytes(unique, w, found))
