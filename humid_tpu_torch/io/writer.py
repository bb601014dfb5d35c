"""FastQ output with transparent gzip compression.

The reference uses fastp's ``Writer`` which gzip-compresses when the output
name ends in ``.gz`` (humid.cc:216-217).  Records are written as canonical
4-line blocks, byte-identical to fastp's ``Read::toString()``.

Record assembly is fully vectorized: the selected line spans are gathered
from the batch buffer into one contiguous output buffer with a ragged
gather/scatter (no per-record Python on the hot path).
"""

from __future__ import annotations

import gzip

import numpy as np

from .reader import FastqBatch

try:
    from ._fastqio import concat_segments as _concat_native
except ImportError:  # pragma: no cover - extension not built
    _concat_native = None


def _build_output(src: np.ndarray, seg_start: np.ndarray,
                  seg_len: np.ndarray, nl_after: np.ndarray) -> np.ndarray:
    """Concatenate ragged segments of ``src`` (uint8), appending a newline
    after each segment where ``nl_after`` is True.

    seg_start/seg_len: [M] int64 flat segment table, in output order.
    """
    seg_start = seg_start.astype(np.int64, copy=False)
    seg_len = seg_len.astype(np.int64, copy=False)
    if _concat_native is not None:
        return _concat_native(src, seg_start, seg_len, nl_after)
    total_data = int(seg_len.sum())
    out_len = total_data + int(nl_after.sum())
    out = np.empty(out_len, np.uint8)
    if out_len == 0:
        return out
    cum_in = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
    out_start = cum_in + np.concatenate([[0], np.cumsum(nl_after)[:-1]])
    nl_pos = (out_start + seg_len)[nl_after]
    out[nl_pos] = 10
    r = np.arange(total_data, dtype=np.int64)
    rep_src = np.repeat(seg_start - cum_in, seg_len) + r
    rep_dst = np.repeat(out_start - cum_in, seg_len) + r
    out[rep_dst] = src[rep_src]
    return out


def _ann_buffer(cluster_ids: np.ndarray):
    """Vectorized b":<id>" annotation strings -> (flat uint8 buffer,
    starts [n], lens [n]).  Digits are placed right-aligned per row with
    ~log10(max_id) vector passes (np.char.mod is per-element Python)."""
    ids = cluster_ids.astype(np.int64)
    n = len(ids)
    ndig = np.ones(n, np.int64)
    p = 10
    while int(ids.max(initial=0)) >= p:
        ndig += ids >= p
        p *= 10
    max_d = int(ndig.max(initial=1))
    width = 1 + max_d
    # Row layout: [junk..., ':', digits...] with the colon right before the
    # first significant digit.  Digits are written as dense column stores
    # (right-aligned, leading "zeros" become junk); only the colon needs a
    # scatter.
    buf = np.zeros((n, width), np.uint8)
    v = ids.copy()
    for d in range(max_d):
        np.add(v % 10, ord("0"), out=buf[:, width - 1 - d],
               casting="unsafe")
        v //= 10
    rows = np.arange(n, dtype=np.int64)
    offs = max_d - ndig
    buf[rows, offs] = ord(":")
    lens = 1 + ndig
    starts = rows * width + offs
    return buf.ravel(), starts, lens


def build_records(batch: FastqBatch, indices: np.ndarray) -> np.ndarray:
    """Assemble the selected records of a batch (in index order) into one
    contiguous uint8 buffer of canonical 4-line records."""
    if len(indices) == 0:
        return np.zeros(0, np.uint8)
    starts = batch.starts[indices]          # [k, 4]
    ends = batch.ends[indices]
    seg_start = starts.ravel()
    seg_len = (ends - starts).ravel()
    nl_after = np.ones(len(seg_start), dtype=bool)
    return _build_output(batch.buf, seg_start, seg_len, nl_after)


def build_records_annotated(
    batch: FastqBatch, cluster_ids: np.ndarray
) -> np.ndarray:
    """Assemble ALL records with ``:<cluster_id>`` appended to every name
    line (humid.cc:280-284) into one contiguous uint8 buffer."""
    k = batch.n
    if k == 0:
        return np.zeros(0, np.uint8)
    ann_buf, ann_starts, ann_lens = _ann_buffer(cluster_ids)
    src = np.concatenate([batch.buf, ann_buf])
    base = len(batch.buf)
    # 5 segments/record: name (no newline), ":id", seq, strand, qual.
    seg_start = np.empty((k, 5), np.int64)
    seg_len = np.empty((k, 5), np.int64)
    seg_start[:, 0] = batch.starts[:, 0]
    seg_len[:, 0] = batch.ends[:, 0] - batch.starts[:, 0]
    seg_start[:, 1] = base + ann_starts
    seg_len[:, 1] = ann_lens
    seg_start[:, 2:] = batch.starts[:, 1:]
    seg_len[:, 2:] = batch.ends[:, 1:] - batch.starts[:, 1:]
    nl_after = np.tile(
        np.array([False, True, True, True, True]), (k, 1)
    ).ravel()
    return _build_output(src, seg_start.ravel(), seg_len.ravel(), nl_after)


def compress_member(out: np.ndarray, compression: int = 4) -> bytes:
    """One deterministic gzip member for a record buffer.  Members
    concatenate into a valid multi-member gzip stream, which lets
    writers compress batches on a thread pool instead of through one
    serial stream (zlib releases the GIL)."""
    return gzip.compress(bytes(out.data), compression, mtime=0)


class FastqWriter:
    """FastQ output writer.

    Gzip outputs are written as a sequence of independent gzip members
    (one per batch) — a valid gzip stream whose decompressed content is
    byte-identical to the reference's single-stream output, and whose
    compression parallelizes across batches (see
    :func:`compress_member` and pipeline._pipelined_write).
    """

    def __init__(self, path: str, compression: int = 4,
                 compress: bool | None = None):
        """Gzip output when ``compress``, or with ``compress`` None when
        ``path`` ends in ``.gz`` (a part file of a multi-process run,
        ``<final>.partNNNNN``, hides its final name's suffix)."""
        self.path = path
        self.compression = compression
        self.is_gz = path.endswith(".gz") if compress is None else compress
        self._f = open(path, "wb")
        self._wrote = False

    def write_payload(self, payload) -> None:
        """Write an already-finalized payload: ``bytes`` are assumed to
        be a complete gzip member (or raw bytes for plain files); numpy
        buffers are raw records, compressed here if needed."""
        if isinstance(payload, (bytes, bytearray)):
            if len(payload):
                self._f.write(payload)
                self._wrote = True
            return
        self.write_array(payload)

    def write_array(self, out: np.ndarray) -> None:
        """Write a pre-assembled record buffer (no copy for plain files)."""
        if not len(out):
            return
        if self.is_gz:
            self._f.write(compress_member(out, self.compression))
        else:
            self._f.write(out.data)
        self._wrote = True

    def write_records(self, batch: FastqBatch, indices: np.ndarray) -> None:
        """Write the records ``indices`` of ``batch``, in that order."""
        self.write_array(build_records(batch, indices))

    def write_records_annotated(self, batch: FastqBatch,
                                cluster_ids: np.ndarray) -> None:
        """Write every record of ``batch`` with ``:<cluster_id>`` appended
        to its name line (humid.cc:280-284)."""
        self.write_array(build_records_annotated(batch, cluster_ids))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self.is_gz and not self._wrote:
            # An empty gzip file must still be a valid (empty) member.
            self._f.write(gzip.compress(b"", self.compression, mtime=0))
        self._f.close()
