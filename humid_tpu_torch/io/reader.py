"""Batched FastQ reading.

The reference consumes fastp's ``FastqReader::read()`` one record at a time
(fastq.cc:37-47) and iterates multiple files in lockstep, stopping as soon
as ANY file reaches EOF (fastq.cc:96-114).  Here the reader is batch
oriented: it decompresses in large chunks, frames records by newline
positions with numpy (no per-record Python work on the hot path), and
exposes vectorized accessors that return fixed-width uint8 matrices ready
for :mod:`humid_tpu_torch.words`.

A C++ fast path (csrc/fastqio.cpp) replaces the framing loop when the
compiled extension is available; both produce identical ``FastqBatch``es.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

_NEWLINE = 10
_CR = 13

try:  # native bulk framing (csrc/fastqio.cpp); numpy fallback below
    from ._fastqio import count_newlines as _count_newlines_native
    from ._fastqio import frame as _frame_native
    from ._fastqio import scan_frames as _scan_frames_native
    from ._fastqio import scan_frames_prefix as _scan_frames_prefix_native
    from ._fastqio import gather_prefix as _gather_prefix_native
except ImportError:  # pragma: no cover - extension not built
    _frame_native = None
    _scan_frames_native = None
    _count_newlines_native = None
    _scan_frames_prefix_native = None
    _gather_prefix_native = None


# Whole-buffer libdeflate decompression beats streaming zlib only while
# the file is small; past this the prefetch thread's pipelining of
# streaming decompression with downstream packing wins (measured).
_LIBDEFLATE_MAX = 1 << 23


def _open_stream(path: str):
    """Raw byte stream with transparent gzip decoding.  Small-enough gzip
    files decompress in one shot via libdeflate (csrc/fastqio.cpp — the
    reference links isa-l/libdeflate for the same job); larger ones
    stream through zlib."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic != b"\x1f\x8b":
        return f
    try:
        import os as _os

        if (_frame_native is not None
                and _os.fstat(f.fileno()).st_size <= _LIBDEFLATE_MAX):
            from ._fastqio import gzip_decompress

            raw = gzip_decompress(f.read())
            if raw is not None:
                f.close()
                import io as _io

                return _io.BytesIO(raw)
            f.seek(0)
    except Exception:
        f.seek(0)
    return gzip.open(f, "rb")


@dataclass
class FastqBatch:
    """A batch of parsed FastQ records backed by one contiguous buffer.

    ``starts``/``ends`` are [n, 4] int64 line spans into ``buf`` for the
    (name, sequence, strand, quality) lines, with trailing ``\\r`` stripped.
    """

    buf: np.ndarray  # uint8 view of the underlying bytes
    starts: np.ndarray
    ends: np.ndarray
    # Optional [n, k] 'N'-padded first-k sequence bytes, gathered during
    # framing while the record bytes were cache-hot (csrc/fastqio.cpp
    # scan_frames_prefix).  None when framing ran without the hint.
    prefix: np.ndarray | None = None

    @property
    def n(self) -> int:
        return self.starts.shape[0]

    def line_matrix(self, line: int, width: int, fill: int = 0) -> np.ndarray:
        """Fixed-width [n, width] uint8 matrix of line ``line`` (0=name,
        1=seq, 3=qual), cut to ``width`` and padded with ``fill``."""
        s = self.starts[:, line]
        e = self.ends[:, line]
        lens = e - s
        idx = s[:, None] + np.arange(width, dtype=np.int64)[None, :]
        np.clip(idx, 0, max(len(self.buf) - 1, 0), out=idx)
        out = self.buf[idx]
        mask = np.arange(width, dtype=np.int64)[None, :] >= lens[:, None]
        return np.where(mask, np.uint8(fill), out)

    def seq_prefix(self, k: int) -> np.ndarray:
        """First ``k`` bases of every sequence, cut/padded with 'N'
        (fastq.cc:131-142)."""
        if self.prefix is not None and self.prefix.shape[1] == k:
            return self.prefix
        return self.line_matrix(1, k, fill=ord("N"))

    def max_line_len(self, line: int) -> int:
        if self.n == 0:
            return 0
        return int((self.ends[:, line] - self.starts[:, line]).max())

    def name_matrix(self) -> np.ndarray:
        """Header lines as a NUL-padded matrix (for vectorized UMI parsing)."""
        return self.line_matrix(0, max(self.max_line_len(0), 1), fill=0)

    def slice_records(self, s: int, e: int) -> "FastqBatch":
        """Zero-copy view of records [s, e)."""
        return FastqBatch(self.buf, self.starts[s:e], self.ends[s:e],
                          None if self.prefix is None else self.prefix[s:e])

    def line_bytes(self, i: int, line: int) -> bytes:
        """Line ``line`` (0-3) of record ``i``, without its newline."""
        return self.buf[self.starts[i, line]:self.ends[i, line]].tobytes()

    def record_bytes(self, i: int) -> bytes:
        """Record ``i`` as its canonical 4-line bytes (what the writers
        emit for it)."""
        return b"\n".join(self.line_bytes(i, j) for j in range(4)) + b"\n"


def _frame(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Find complete 4-line records in ``buf``.  Returns (starts, ends,
    consumed_bytes) where starts/ends are buffer-relative [n,4] spans."""
    if _frame_native is not None:
        return _frame_native(buf)
    nl = np.flatnonzero(buf == _NEWLINE)
    n = len(nl) // 4
    if n == 0:
        return (np.zeros((0, 4), np.int64), np.zeros((0, 4), np.int64), 0)
    nl4 = nl[: 4 * n].reshape(n, 4)
    line_ends = nl4.astype(np.int64)
    line_starts = np.empty_like(line_ends)
    line_starts[0, 0] = 0
    flat_e = line_ends.ravel()
    line_starts.ravel()[1:] = flat_e[:-1] + 1
    # Strip trailing \r.
    has_cr = buf[np.maximum(line_ends - 1, 0)] == _CR
    line_ends = line_ends - has_cr.astype(np.int64)
    consumed = int(nl4[-1, -1]) + 1
    return line_starts, line_ends, consumed


def _prefix_for(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                k: int) -> np.ndarray | None:
    """Post-hoc prefix gather for batches framed without the fused path
    (straddling records, numpy fallback).  Native-only: the prefix hint
    is only ever requested when the extension is loaded."""
    if _gather_prefix_native is None or k <= 0:
        return None
    pref = np.empty((starts.shape[0], k), np.uint8)
    if starts.shape[0]:
        _gather_prefix_native(buf, starts[:, 1], ends[:, 1], pref, 0, k)
    return pref


def _frame_chunk(buf: np.ndarray, skip_nl: int, prefix_k: int = 0):
    """Frame one raw chunk independently of its neighbours.

    ``skip_nl`` newlines separate the chunk start from the first record
    boundary (derived from the cumulative newline count mod 4 — valid
    FastQ is strictly 4 lines per record, which is also what the
    sequential framer assumes).  Returns (head_end, starts, ends, pref,
    consumed) where buf[:head_end] belongs to the record straddling the
    previous chunk, buf[consumed:] to the one straddling the next, and
    pref is the fused [n, prefix_k] sequence-prefix gather (None when
    prefix_k == 0 or the fused native path is unavailable).  Returns
    head_end = -1 (with starts/ends/pref None and consumed = len(buf))
    when the chunk contains fewer than ``skip_nl`` newlines (the whole
    chunk is interior to the straddling record).
    """
    h = 0
    if skip_nl:
        win = 4096
        while True:
            nl = np.flatnonzero(buf[:win] == _NEWLINE)
            if len(nl) >= skip_nl:
                h = int(nl[skip_nl - 1]) + 1
                break
            if win >= len(buf):
                return -1, None, None, None, len(buf)
            win *= 8
    fused = prefix_k > 0 and _scan_frames_prefix_native is not None
    parts_s, parts_e, parts_p = [], [], []
    off = h
    while off < len(buf):
        cap = (len(buf) - off) // 64 + 64
        if fused:
            s, e, p, c = _scan_frames_prefix_native(buf[off:], cap,
                                                    prefix_k)
            parts_p.append(p)
        else:
            s, e, c = _scan_frames_native(buf[off:], cap)
        if s.shape[0] == 0:
            break
        parts_s.append(s + off)
        parts_e.append(e + off)
        off += c
        if s.shape[0] < cap:  # scan stopped at an incomplete record
            break
    if parts_s:
        starts = (parts_s[0] if len(parts_s) == 1
                  else np.concatenate(parts_s))
        ends = (parts_e[0] if len(parts_e) == 1
                else np.concatenate(parts_e))
        pref = (None if not fused else
                (parts_p[0] if len(parts_p) == 1
                 else np.concatenate(parts_p)))
    else:
        starts = np.zeros((0, 4), np.int64)
        ends = np.zeros((0, 4), np.int64)
        pref = np.zeros((0, prefix_k), np.uint8) if fused else None
    return h, starts, ends, pref, off


class _Readahead:
    """Bounded read-ahead thread over a byte stream, so gzip inflation
    overlaps the consumer's framing/packing (both sides release the
    GIL)."""

    def __init__(self, stream, chunk_bytes: int, depth: int = 4):
        import queue
        import threading

        self._stream = stream
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            try:
                while not self._stop.is_set():
                    data = stream.read(chunk_bytes)
                    self._q.put(data)
                    if not data:
                        return
            except BaseException as e:
                self._q.put(e)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def read(self, _n: int = -1) -> bytes:
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
        self._t.join(timeout=5)
        self._stream.close()


class FastqReader:
    """Chunked FastQ reader yielding :class:`FastqBatch` objects."""

    def __init__(self, path: str, chunk_bytes: int = 32 * 1024 * 1024,
                 frame_workers: int = 4, prefix_k: int = 0,
                 start_offset: int = 0):
        self.path = path
        self.chunk_bytes = chunk_bytes
        self.frame_workers = frame_workers
        # When > 0, frame with the fused sequence-prefix gather so every
        # batch carries FastqBatch.prefix (the word packer's input) —
        # saves a scattered re-walk of the buffer.
        self.prefix_k = (prefix_k
                         if _scan_frames_prefix_native is not None else 0)
        # Byte offset (in decompressed stream coordinates) to start
        # framing from; it must point at a record boundary
        # (skip_to_record).  Lets a host-range reader skip the records
        # before its range without framing them.
        self.start_offset = start_offset

    # Gzip files up to this COMPRESSED size are inflated in one
    # libdeflate call (2-3x faster than streaming zlib) and framed by
    # the parallel path; larger ones stream (bounded memory).
    _GZ_ONESHOT_MAX = 256 * 1024 * 1024

    def _materialize(self) -> np.ndarray | None:
        """Whole file as a uint8 buffer when that is cheap: plain files
        via mmap (zero-copy, page-cache backed), moderate gzip files via
        one-shot libdeflate.  None -> use the streaming path."""
        try:
            f = open(self.path, "rb")
        except OSError:
            return None
        try:
            if f.read(2) != b"\x1f\x8b":
                import mmap as _mmap

                try:
                    mm = _mmap.mmap(f.fileno(), 0, prot=_mmap.PROT_READ)
                except (ValueError, OSError):
                    return None  # empty file or unmappable stream
                full = np.frombuffer(mm, np.uint8)
                return full[self.start_offset:] if self.start_offset else full
            import os as _os

            if _os.fstat(f.fileno()).st_size <= self._GZ_ONESHOT_MAX:
                try:
                    from ._fastqio import gzip_decompress
                except ImportError:
                    return None
                f.seek(0)
                raw = gzip_decompress(f.read())
                if raw is not None:
                    full = np.frombuffer(raw, np.uint8)
                    return (full[self.start_offset:]
                            if self.start_offset else full)
            return None
        finally:
            f.close()

    def records(self) -> Iterator[FastqBatch]:
        """The file's records, batch by batch (:meth:`batches`)."""
        return self.batches()

    def batches(self) -> Iterator[FastqBatch]:
        if (self.frame_workers > 1 and _scan_frames_native is not None
                and _count_newlines_native is not None):
            full = self._materialize()
            if full is not None:
                yield from self._batches_parallel(full)
                return
        yield from self._batches_sequential()

    def _batches_parallel(self, full: np.ndarray) -> Iterator[FastqBatch]:
        """Whole-buffer reading with chunk framing fanned out to a
        thread pool (buffer = mmap of a plain file or a one-shot-
        inflated gzip).

        The producer walks fixed chunk ranges of the buffer, tracking
        the cumulative newline count (memchr-speed) so each chunk's
        record phase is known at submit time; workers frame their chunk
        independently; results are consumed in order.  All batches are
        zero-copy views of the buffer, and the record straddling a
        chunk boundary is just the contiguous slice between the previous
        chunk's last complete record and the next chunk's first — no
        assembly buffers.
        """
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        total = len(full)
        tail_start = 0  # file offset of the straddling record's first byte
        nl_total = 0
        prev_boundary = True

        def consume(item) -> Iterator[FastqBatch]:
            nonlocal tail_start
            lo, hi, fut = item
            head_end, starts, ends, pref, consumed = fut.result()
            if head_end < 0:  # chunk interior to a straddling record
                return
            straddle_end = lo + head_end
            if straddle_end > tail_start:
                sbuf = full[tail_start:straddle_end]
                ss, se, _ = _frame(sbuf)
                if ss.shape[0]:
                    yield FastqBatch(sbuf, ss, se,
                                     _prefix_for(sbuf, ss, se,
                                                 self.prefix_k))
            if starts.shape[0]:
                yield FastqBatch(full[lo:hi], starts, ends, pref)
            tail_start = lo + consumed

        with ThreadPoolExecutor(max_workers=self.frame_workers) as ex:
            inflight: deque = deque()
            for lo in range(0, total, self.chunk_bytes):
                hi = min(lo + self.chunk_bytes, total)
                chunk = full[lo:hi]
                phase = nl_total & 3
                skip = ((4 - phase) & 3) if prev_boundary else 4 - phase
                nl_total += _count_newlines_native(chunk)
                prev_boundary = full[hi - 1] == _NEWLINE
                inflight.append(
                    (lo, hi, ex.submit(_frame_chunk, chunk, skip,
                                       self.prefix_k)))
                while len(inflight) > self.frame_workers + 1:
                    yield from consume(inflight.popleft())
            while inflight:
                yield from consume(inflight.popleft())
        if tail_start < total:
            pending = full[tail_start:].tobytes()
            if pending.strip():
                # Trailing record without final newline (fastp tolerates
                # a missing one).
                data = (pending if pending.endswith(b"\n")
                        else pending + b"\n")
                buf = np.frombuffer(data, np.uint8)
                starts, ends, _ = _frame(buf)
                if starts.shape[0]:
                    yield FastqBatch(buf, starts, ends,
                                     _prefix_for(buf, starts, ends,
                                                 self.prefix_k))

    def _batches_sequential(self) -> Iterator[FastqBatch]:
        stream = _open_stream(self.path)
        if self.start_offset:
            # Decompressed-coordinate seek (gzip.GzipFile inflates up to
            # the target; plain files seek directly).
            stream.seek(self.start_offset)
        if isinstance(stream, gzip.GzipFile) and self.frame_workers > 1:
            stream = _Readahead(stream, self.chunk_bytes)
        leftover = b""
        avg_rec = 0.0  # running bytes/record -> single-pass scan capacity
        try:
            while True:
                chunk = stream.read(self.chunk_bytes)
                if not chunk:
                    break
                data = leftover + chunk if leftover else chunk
                buf = np.frombuffer(data, dtype=np.uint8)
                pref = None
                if _scan_frames_native is not None and avg_rec:
                    # Single-pass framing; a capacity underestimate just
                    # leaves complete records in the leftover for the
                    # next round.
                    cap = int(len(buf) / avg_rec * 1.25) + 16
                    if self.prefix_k > 0:
                        starts, ends, pref, consumed = (
                            _scan_frames_prefix_native(buf, cap,
                                                       self.prefix_k))
                    else:
                        starts, ends, consumed = _scan_frames_native(
                            buf, cap)
                else:
                    starts, ends, consumed = _frame(buf)
                    pref = _prefix_for(buf, starts, ends, self.prefix_k)
                if starts.shape[0] == 0:
                    leftover = data
                    continue
                avg_rec = consumed / starts.shape[0]
                leftover = data[consumed:]
                # Read-only view; `data` stays alive via the view. No copy.
                yield FastqBatch(buf[:consumed], starts, ends, pref)
            if leftover.strip():
                # Trailing data without final newline: frame what remains by
                # appending a synthetic newline (fastp tolerates a missing
                # final newline).
                data = leftover if leftover.endswith(b"\n") else leftover + b"\n"
                buf = np.frombuffer(data, dtype=np.uint8)
                starts, ends, _ = _frame(buf)
                if starts.shape[0]:
                    yield FastqBatch(buf, starts, ends,
                                     _prefix_for(buf, starts, ends,
                                                 self.prefix_k))
        finally:
            stream.close()


def iter_chunk_newline_counts(stream, chunk_bytes: int = 32 * 1024 * 1024):
    """Yield (chunk bytes, newline count) over a byte stream: the shared
    inner loop of record counting and offset scans (the native counter
    when the extension is built)."""
    while True:
        data = stream.read(chunk_bytes)
        if not data:
            return
        if _count_newlines_native is not None:
            yield data, int(_count_newlines_native(
                np.frombuffer(data, np.uint8)))
        else:
            yield data, data.count(b"\n")


def skip_to_record(path: str, k: int) -> int | None:
    """Byte offset of record ``k`` in a plain (non-gzip) FastQ file: the
    position just after the ``4*k``-th newline (valid FastQ is strictly
    4 lines a record, the framer's own rule).  A raw newline-count scan,
    cheaper than framing; None for gzip inputs or files with fewer than
    ``k`` records (callers then frame from the start)."""
    if k <= 0:
        return 0
    if is_gzip_file(path):
        return None
    need = 4 * k
    seen = 0
    base = 0
    try:
        with open(path, "rb") as f:
            for chunk, n in iter_chunk_newline_counts(f):
                if seen + n >= need:
                    buf = np.frombuffer(chunk, np.uint8)
                    pos = np.flatnonzero(buf == _NEWLINE)[need - seen - 1]
                    return base + int(pos) + 1
                seen += n
                base += len(chunk)
    except OSError:
        return None
    return None  # fewer than k records


def is_gzip_file(path: str) -> bool:
    """True when the file CONTENT is gzip (magic bytes — the name is not
    trusted)."""
    try:
        with open(path, "rb") as f:
            return f.read(2) == b"\x1f\x8b"
    except OSError:
        return False


def peek_first_record(path: str) -> tuple[bytes, bytes]:
    """(name_line, seq_line) of the first record (humid.cc:24-33)."""
    stream = _open_stream(path)
    try:
        name = stream.readline().rstrip(b"\r\n")
        seq = stream.readline().rstrip(b"\r\n")
    finally:
        stream.close()
    if not name:
        from ..errors import InputError

        raise InputError(f"{path}: empty FastQ file")
    return name, seq


class _BatchCursor:
    """Re-batching cursor so multiple files can be consumed in lockstep."""

    def __init__(self, reader: FastqReader):
        self._it = reader.batches()
        self._pending: list[FastqBatch] = []
        self._avail = 0
        self._done = False

    def _fill(self, want: int) -> None:
        while self._avail < want and not self._done:
            try:
                b = next(self._it)
            except StopIteration:
                self._done = True
                return
            if b.n:
                self._pending.append(b)
                self._avail += b.n

    def available(self, want: int) -> int:
        self._fill(want)
        return self._avail

    def natural_size(self) -> int:
        """Records in the first pending batch (0 at EOF).  Taking at most
        this many from THIS cursor is a zero-copy view split."""
        self._fill(1)
        return self._pending[0].n if self._pending else 0

    def take(self, k: int) -> FastqBatch:
        self._fill(k)
        assert self._avail >= k
        taken: list[FastqBatch] = []
        need = k
        while need:
            b = self._pending[0]
            if b.n <= need:
                taken.append(b)
                self._pending.pop(0)
                need -= b.n
            else:
                taken.append(b.slice_records(0, need))
                self._pending[0] = b.slice_records(need, b.n)
                need = 0
        self._avail -= k
        if len(taken) == 1:
            return taken[0]
        return _concat_batches(taken)


def _concat_batches(batches: list[FastqBatch]) -> FastqBatch:
    bufs = [b.buf for b in batches]
    offsets = np.cumsum([0] + [len(x) for x in bufs[:-1]])
    buf = np.concatenate(bufs)
    starts = np.concatenate([b.starts + o for b, o in zip(batches, offsets)])
    ends = np.concatenate([b.ends + o for b, o in zip(batches, offsets)])
    prefix = None
    if all(b.prefix is not None for b in batches) and len(
            {b.prefix.shape[1] for b in batches}) == 1:
        prefix = np.concatenate([b.prefix for b in batches])
    return FastqBatch(buf, starts, ends, prefix)


def _read_tuples_sync(
    files: Sequence[str], batch_records: int,
    prefix_ks: Sequence[int] | None = None,
    start_offsets: Sequence[int] | None = None,
) -> Iterator[list[FastqBatch]]:
    # Split the framing pool across the lockstep files so n_files
    # concurrent readers don't oversubscribe the host.
    workers = max(2, 4 // max(1, len(files)))
    ks = list(prefix_ks) if prefix_ks is not None else [0] * len(files)
    offs = (list(start_offsets) if start_offsets is not None
            else [0] * len(files))
    cursors = [_BatchCursor(FastqReader(f, frame_workers=workers,
                                        prefix_k=k, start_offset=o))
               for f, k, o in zip(files, ks, offs)]
    while True:
        # Natural (chunk-aligned) sizes make take() a zero-copy view split
        # for at least one cursor and avoid cross-chunk concatenation;
        # batch_records is only an upper bound, not a forced size.
        n = min(c.natural_size() for c in cursors)
        n = min(n, batch_records)
        if n == 0:  # some file exhausted: stop (fastq.cc:41-43)
            return
        yield [c.take(n) for c in cursors]


def read_tuples(
    files: Sequence[str], batch_records: int = 1 << 19,
    prefetch: int = 2,
    prefix_ks: Sequence[int] | None = None,
    start_offsets: Sequence[int] | None = None,
) -> Iterator[list[FastqBatch]]:
    """Lockstep iteration over multiple FastQ files in batches.

    Yields lists of equal-length batches (one per file).  Iteration stops at
    the shortest file, matching the reference's behaviour of stopping when
    ANY reader hits EOF and discarding the partial tuple (fastq.cc:41-43,
    104).

    ``prefix_ks`` (one k per file) requests the fused sequence-prefix
    gather: each yielded batch then carries ``FastqBatch.prefix``.

    ``start_offsets`` (one byte offset per file, from
    :func:`skip_to_record`) starts framing mid-file, so a host-range
    reader skips the records before its range.

    Batches are produced by a background thread (``prefetch`` queue depth)
    so decompression + framing overlap the consumer's packing/writing —
    both sides spend their time in GIL-releasing C calls.
    """
    if prefetch <= 0:
        yield from _read_tuples_sync(files, batch_records, prefix_ks,
                                     start_offsets)
        return

    import queue as _queue
    import threading

    q: _queue.Queue = _queue.Queue(maxsize=prefetch)
    _END = object()
    stop = threading.Event()

    def worker():
        try:
            for item in _read_tuples_sync(files, batch_records, prefix_ks,
                                          start_offsets):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except _queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_END)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            q.get_nowait()
        except _queue.Empty:
            pass
        t.join(timeout=5)
