"""Wrapper around the port's native UMI parse (csrc/umi_parse.cpp).

Raises ImportError when the extension is not built; pass 1 then parses
UMIs with numpy (:func:`humid_tpu_torch.words.extract_umi_matrix`).
Build with: python setup.py build_ext --inplace
"""

from __future__ import annotations

import numpy as np

from . import _cumi


def gather_umi(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray,
               out: np.ndarray, col_off: int, umi_size: int) -> None:
    """Write the UMI of each (start, end) header span of ``buf``, cut or
    padded with 'N' to ``umi_size`` (:func:`.words.extract_umi` +
    :func:`.words.make_string_size`), into ``out[:, col_off:col_off +
    umi_size]`` (uint8, rows C-contiguous)."""
    if out.dtype != np.uint8 or out.ndim != 2:
        raise ValueError("gather_umi: out must be a 2-D uint8 matrix")
    if col_off < 0 or umi_size < 0 or col_off + umi_size > out.shape[1]:
        raise ValueError("gather_umi: columns outside out")
    _cumi.gather_umi(
        buf, np.ascontiguousarray(starts, np.int64),
        np.ascontiguousarray(ends, np.int64), out, out.strides[0],
        col_off, umi_size,
    )
