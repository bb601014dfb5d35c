"""Small shared host utilities."""

from __future__ import annotations

import os


_malloc_tuned = False


def tune_malloc() -> None:
    """Keep freed large buffers on the malloc heap instead of returning
    them to the kernel (mmap/munmap per allocation): the pipeline's host
    phases cycle many multi-hundred-MB numpy scratch buffers, and on
    virtualized hosts re-faulting returned pages is erratically slow.
    With a high mmap threshold + trim disabled, pages are faulted once
    per process and reused by every later phase.

    Called from the CLI / pipeline entry points — NOT at package import —
    so merely importing humid_tpu_torch never mutates a host
    application's process-global glibc allocator.  Opt out with
    HUMID_TPU_TORCH_NO_MALLOC_TUNE=1."""
    global _malloc_tuned
    if _malloc_tuned or os.environ.get("HUMID_TPU_TORCH_NO_MALLOC_TUNE"):
        return
    _malloc_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 0x7FFFFFFF)
    except (OSError, AttributeError):  # pragma: no cover - non-glibc
        pass


def avail_bytes(default: int = 1 << 33) -> int:
    """Available physical memory in bytes (``default`` when the sysconf
    probe is unsupported)."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return default


def concat_aranges(lens):
    """[0..lens[0]), [0..lens[1]), ... concatenated, vectorized: the
    within-segment iota of a ragged gather (the mesh search's run
    expander)."""
    import numpy as np

    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.int64)
    offs = np.repeat(np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return np.arange(total, dtype=np.int64) - offs
