"""The simplex encoding that both int8 tensor-core kernels read: its plain
PyTorch version (:func:`encode_table`), the wrapper of its CUDA pre-pass
(:func:`encode`, ``csrc/simplex_encode.cu``) and the pass threshold of the
products.

Each base slot of a word becomes 3 int8 channels of +-1 (:data:`SIMPLEX`),
so that the integer product of two words' rows is 48 w - 4 * distance and
a pair is within ``max_dist`` iff that product reaches
:func:`pass_threshold`.  The tile sweep (``ops/cuda_hamming.py``, K1)
encodes its table once per call; the ring (``parallel/cuda_ring.py``,
K2) encodes its own block once and each received block as it arrives.

On a CUDA tensor :func:`encode` launches the kernel or raises; on a CPU
tensor, and only there, it runs :func:`encode_table` in its place.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .hamming import base_codes

#: Kernel launches in this process (one per launch of the CUDA encoder,
#: nowhere else); callers reset it to 0 to count one run's launches.
LAUNCHES = 0

#: The kernels' encoding of a base, 3 int8 channels in code order A C G T:
#: the product of two bases' channels is 3 when they are equal, -1 when
#: not.
SIMPLEX = ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1))
#: The encoded table's rows are a multiple of this (one TMA box of the
#: kernels, one 64-row wgmma tile).
TABLE_ROWS = 64
#: Rows encoded at a time by the plain version (bounds its scratch at 2^23
#: rows).
_ENCODE_ROWS = 1 << 20


def table_width(w: int) -> int:
    """Bytes of a word of ``w`` lanes in the encoded table: 3 channels of
    its 16 w base slots, rounded up to a multiple of 32 (the kernels'
    k-step)."""
    return -(-48 * w // 32) * 32


def table_rows(n: int) -> int:
    """Rows of the encoded table of ``n`` words: a multiple of
    :data:`TABLE_ROWS`, at least one."""
    return max(-(-n // TABLE_ROWS), 1) * TABLE_ROWS


def encode_table(lanes: torch.Tensor) -> torch.Tensor:
    """[N, w] lanes -> the kernels' K-major [R, K] int8 table on the same
    device: row g holds the :data:`SIMPLEX` channels of all 16 w base
    slots of word g (padding slots too: code A in every word), columns
    from 48 w on zero up to K = :func:`table_width`, rows from N on zero
    up to R = :func:`table_rows`.  The plain version of :func:`encode`."""
    n, w = lanes.shape
    out = torch.zeros((table_rows(n), table_width(w)), dtype=torch.int8,
                      device=lanes.device)
    for lo in range(0, n, _ENCODE_ROWS):
        codes = base_codes(lanes[lo:lo + _ENCODE_ROWS]).to(torch.int8)
        hi, low = codes >> 1, codes & 1
        # SIMPLEX by arithmetic (no host table to copy): 1 - 2 * bit.
        channels = torch.stack([hi, low, hi ^ low], dim=2)
        out[lo:lo + len(codes), :48 * w] = (1 - 2 * channels).reshape(
            len(codes), 48 * w)
    return out


def pass_threshold(w: int, max_dist: int) -> int:
    """The least product of two encoded rows of ``w`` lanes whose words
    are at most ``max_dist`` bases apart: the product is 4 * matches -
    16 w = 48 w - 4 * distance over all 16 w slots, so a pair passes iff
    it is at least 48 w - 4 * max_dist.  ``max_dist`` is clamped to
    [-1, 16 w]: below 0 nothing passes, from 16 w on every pair does."""
    return 48 * w - 4 * min(max(max_dist, -1), 16 * w)


@functools.cache
def _kernel_fn():
    from .. import _build

    fn = _build.load("simplex_encode").humid_simplex_encode
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, i64, i32, p, i64, i32, p]
    fn.restype = ctypes.c_int
    return fn


def encode(lanes: torch.Tensor, out: torch.Tensor | None = None
           ) -> torch.Tensor:
    """:func:`encode_table` of ``lanes`` ([N, w] contiguous int32), into
    ``out`` when given (a contiguous [R, K] int8 tensor on the same
    device, R = :func:`table_rows` of N, K = :func:`table_width` of w),
    else into a new tensor; returns the table.  CUDA tensors run the
    hand-written kernel (``csrc/simplex_encode.cu``) on the current
    stream, with no host synchronisation; CPU tensors run
    :func:`encode_table`."""
    global LAUNCHES
    if lanes.dtype != torch.int32 or lanes.dim() != 2 \
            or not lanes.is_contiguous():
        raise ValueError(f"lanes must be a contiguous 2-D int32 tensor, got "
                         f"{lanes.dtype} {tuple(lanes.shape)}")
    n, w = lanes.shape
    shape = (table_rows(n), table_width(w))
    if out is not None and (
            tuple(out.shape) != shape or out.dtype != torch.int8
            or out.device != lanes.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {shape} int8 tensor on "
                         f"{lanes.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if lanes.device.type == "cpu":
        table = encode_table(lanes)
        return table if out is None else out.copy_(table)
    if lanes.device.type != "cuda":
        raise ValueError(f"unsupported device {lanes.device}")
    if out is None:
        out = torch.empty(shape, dtype=torch.int8, device=lanes.device)
    with torch.cuda.device(lanes.device):
        err = _kernel_fn()(lanes.data_ptr(), n, w, out.data_ptr(), shape[0],
                           shape[1],
                           torch.cuda.current_stream(lanes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"simplex_encode launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
