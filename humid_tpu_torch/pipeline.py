"""End-to-end deduplication pipeline.

PyTorch/CUDA port of the reference's ``humid()`` entry point
(humid.cc:369-409), on the main single-device route:

  pass 1  read + pack words     (host, vectorized)     <- readData
  unique  sort/unique counting  (host radix sort or    <- trie leaf counts
                                device sort, routed)
  search  pigeonhole runs engines, Hamming tile sweep  <- asymmetricHamming
          (CUDA kernel), routed by measured constants;
          or, with edit=True, the shifted-segment search and the banded
          Levenshtein programs (host joins, torch)     <- asymmetricLevenshtein
  cluster exact traversal       (host/C++, iterative)  <- cluster.cc
          (-x: device components where routed; directional
          on the device with HUMID_TPU_TORCH_CLUSTER=device)
  pass 2  write outputs         (host, streaming)      <- writeFiltered/
                                                          writeAnnotated

or, for unique counting and the search, the fused device-resident route
(:mod:`.ops.fused`): the packed reads go to the device during pass 1, and
unique counting, the partition sorts, the in-run sweeps and the -x labels
run against that one copy.

The output contract (duplicate sets, annotations, statistics files, file
naming, log phases) is bit-compatible with the reference binary.
"""

from __future__ import annotations

import mmap as _mmap
import os
import re
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from . import words as W
from ._device import resolve_device
from ._util import avail_bytes, tune_malloc
from .cluster import (cluster_exact, cluster_max_from_components,
                      connected_components_device)
from .cluster.exact import CLUSTER_ENV_VAR
from .errors import InputError
from .io import (FastqWriter, build_records, build_records_annotated,
                 make_file_names, peek_first_record, read_tuples)
from .io.reader import is_gzip_file
from .io.writer import _ann_buffer, _build_output, compress_member
from .ops import find_neighbor_pairs, pairs_to_csr, unique_words
from .ops.neighbors import IMPL_ENV_VAR, STRATEGY_ENV_VAR, _combined_u64
from .ops.unique import UNIQUE_ENV_VAR, _stable_argsort_u64
from .phaselog import PhaseLog, no_span
from .stats import write_statistics


@dataclass
class PipelineResult:
    total: int = 0
    usable: int = 0
    unique: int = 0
    clusters: int = 0
    # Arrays for inspection/testing:
    labels: np.ndarray | None = None        # [U] cluster id per unique word
    counts: np.ndarray | None = None        # [U] duplicate count
    rep_reads: np.ndarray | None = None     # representative read indices
    # [N] id per read (0=filtered); only populated when the run computes
    # per-read ids, i.e. write_annotated=True — None otherwise.
    cluster_of_read: np.ndarray | None = None
    degree: np.ndarray | None = None        # [U] neighbour count
    sizes: np.ndarray | None = None         # [K] cluster sizes
    extra: dict = field(default_factory=dict)


def peek_umi_size(path: str) -> int:
    """UMI length of the first record of ``path`` (humid.cc:24-33)."""
    name, _seq = peek_first_record(path)
    return len(W.extract_umi(name.decode("latin1")))


try:
    from .io._fastqio import encode_pack as _encode_pack
    from .io._fastqio import gather_prefix as _gather_prefix
except ImportError:  # pragma: no cover - extension not built
    _encode_pack = _gather_prefix = None
try:
    from .io._umi import gather_umi as _gather_umi
except ImportError:  # pragma: no cover - extension not built
    _gather_umi = None
try:
    from ._hostops import merge_unique_runs as _merge_unique_runs
except ImportError:  # pragma: no cover - extension not built
    _merge_unique_runs = None

#: "1" asks for pass 1 overlapped with unique counting
#: (:func:`overlap_unique`), the reference's HUMID_TPU_OVERLAP_UNIQUE.
OVERLAP_ENV_VAR = "HUMID_TPU_TORCH_OVERLAP_UNIQUE"


def _batch_words(batches, nt_to_take, header_umi_size):
    """One batch tuple -> (packed [n, W], filtered [n], the rows whose UMI
    the native parse produced), via the fused native path (UMI parse,
    gather + encode + pack in C) when available."""
    n = batches[0].n
    wl = header_umi_size + sum(nt_to_take)
    if _encode_pack is not None:
        b0 = batches[0]
        if (header_umi_size == 0 and len(batches) == 1
                and b0.prefix is not None
                and b0.prefix.shape[1] == nt_to_take[0]):
            # Single-file, no-UMI fast path: the fused framing-time
            # prefix IS the word chars matrix — encode it directly.
            return (*_encode_pack(b0.prefix), 0)
        chars = np.empty((n, wl), np.uint8)
        col = umi_native = 0
        if header_umi_size > 0:
            if _gather_umi is not None:
                # Straight from the header spans, without the GIL.
                _gather_umi(b0.buf, b0.starts[:, 0], b0.ends[:, 0], chars,
                            0, header_umi_size)
                umi_native = n
            else:
                chars[:, :header_umi_size] = W.extract_umi_matrix(
                    b0.name_matrix(), header_umi_size,
                    lens=b0.ends[:, 0] - b0.starts[:, 0],
                )
            col = header_umi_size
        for b, k in zip(batches, nt_to_take):
            if k:
                if b.prefix is not None and b.prefix.shape[1] == k:
                    # Row-contiguous copy of the framing-time gather.
                    chars[:, col:col + k] = b.prefix
                else:
                    _gather_prefix(b.buf, b.starts[:, 1], b.ends[:, 1],
                                   chars, col, k)
                col += k
        return (*_encode_pack(chars), umi_native)
    umi_chars = None
    if header_umi_size > 0:
        umi_chars = W.extract_umi_matrix(
            batches[0].name_matrix(), header_umi_size,
            lens=batches[0].ends[:, 0] - batches[0].starts[:, 0],
        )
    seq_chars = [b.seq_prefix(k) for b, k in zip(batches, nt_to_take)]
    codes, filtered = W.build_words(umi_chars, seq_chars)
    return W.pack_words(codes), filtered, 0


def reads_estimate(files) -> int:
    """The reads ``files`` hold, estimated from their size before pass 1:
    ~200 bytes a plain FastQ record under-estimates the rows on purpose
    (the fused route's feeder holds no device memory that the run never
    uses, and doubles if the input runs longer)."""
    return max(_input_bytes_estimate(files) // 200, 1 << 10)


def _input_bytes_estimate(files) -> int:
    """Approximate in-memory size of the parsed inputs (gz assumed ~4x).
    Gzip is detected by CONTENT (magic bytes), matching the reader's
    sniffing."""
    total = 0
    for f in files:
        try:
            sz = os.path.getsize(f)
            gz = is_gzip_file(f)
        except OSError:
            return 1 << 62
        total += sz * 4 if gz else sz
    return total


def _span_acc_new(budget_entries: int, with_hdr: bool = False) -> dict:
    """Accumulator for one file's absolute record-span table (filled by
    ``_span_batch_part`` + ``_span_stitch``).  ``with_hdr`` also collects
    per-record header-line lengths (4B/record) so the annotated writer
    can splice ``:<id>`` after the name without re-framing pass 2."""
    return {"ok": True, "base": 0, "parts": [], "entries": 0,
            "budget": budget_entries,
            "hdr_parts": [] if with_hdr else None}


def _span_batch_part(b, with_hdr: bool = False):
    """Per-batch span math (pool-side, GIL-friendly numpy): relative
    record start offsets within the batch's raw byte run, the run's
    total raw length, and the LF-only validity flag (plus header-line
    lengths when ``with_hdr``).

    Records tile the (decompressed) file, so record i's raw byte length
    is its line contents + 4 newlines — buffer layout (chunk views,
    lockstep re-batching concatenations) never matters.  That identity
    only holds for LF-only files; any ``\\r`` at a line end invalidates
    the table (pass 2 falls back to the re-reading writer)."""
    if b.n == 0:
        return (np.zeros(0, np.int64), 0, True,
                np.zeros(0, np.int32) if with_hdr else None)
    idx = np.minimum(b.ends.reshape(-1), len(b.buf) - 1)
    if bool((b.buf[idx] == 13).any()):
        return None, 0, False, None
    content = (b.ends - b.starts).sum(axis=1, dtype=np.int64) + 4
    cum = np.cumsum(content)
    hdr = ((b.ends[:, 0] - b.starts[:, 0]).astype(np.int32)
           if with_hdr else None)
    return cum - content, int(cum[-1]), True, hdr


def _span_stitch(part, acc: dict) -> None:
    """Append one batch's relative span table to the file accumulator
    (main thread, in batch order).  Offsets let the dedup pass copy the
    SELECTED records' raw bytes straight out of an mmap of the input,
    skipping the second framing scan entirely (the raw bytes equal the
    canonical 4-line record exactly when LF-only — same output as
    build_records)."""
    if part is None or not acc["ok"]:
        return
    rel, total, ok, hdr = part
    if not ok:
        acc["ok"] = False
        acc["parts"] = []
        acc["hdr_parts"] = [] if acc["hdr_parts"] is not None else None
        return
    acc["entries"] += len(rel)
    if acc["entries"] > acc["budget"]:
        acc["ok"] = False
        acc["parts"] = []
        acc["hdr_parts"] = [] if acc["hdr_parts"] is not None else None
        return
    acc["parts"].append(acc["base"] + rel)
    if acc["hdr_parts"] is not None:
        acc["hdr_parts"].append(hdr)
    acc["base"] += total


#: Uniques above which -x asks the router for device components.
DEVICE_COMPONENTS_MIN = 1 << 14

#: A directory: :func:`run` writes a torch.profiler trace of the run there.
PROFILE_ENV_VAR = "HUMID_TPU_TORCH_PROFILE"


def cluster_dispatch(counts, indptr, indices, *, maximum: bool, pairs=None,
                     device_threshold: int = DEVICE_COMPONENTS_MIN,
                     device=None, info: dict | None = None):
    """Cluster by the routed engine.  ``-x`` (maximum) on a table of more
    than ``device_threshold`` uniques, where the router says so for
    ``device``, finds connected components on the device (label
    propagation) and finishes ids, sizes, maxCount and maxLeaf on the
    host (:func:`cluster_max_from_components`, equal to the host walk).
    Directional clustering with $HUMID_TPU_TORCH_CLUSTER=device, pairs
    given and every count below 2^30 runs the device formulation
    (:func:`.cluster.directional_device.cluster_directional_device`, equal
    to the host walk; off by default).  Everything else takes the host
    walk ($HUMID_TPU_TORCH_CLUSTER=parallel or =seq choose its variant,
    :func:`cluster_exact`).  ``info`` receives "components" ("device" or
    "host") for -x and, where the device directional route was asked
    for, "directional" ("device", or "host" where the table did not
    qualify)."""
    if not maximum and os.environ.get(CLUSTER_ENV_VAR) == "device":
        on_device = pairs is not None and (
            len(counts) == 0 or int(np.max(counts)) < (1 << 30))
        if info is not None:
            info["directional"] = "device" if on_device else "host"
        if on_device:
            from .cluster.directional_device import (
                cluster_directional_device)

            return cluster_directional_device(counts, pairs[0], pairs[1],
                                              device=device)
    if maximum:
        from ._backend import use_device_engine

        on_device = (pairs is not None and device is not None
                     and len(counts) > device_threshold
                     and use_device_engine("cc", device, len(counts)))
        if info is not None:
            info["components"] = "device" if on_device else "host"
        if on_device:
            cc = connected_components_device(pairs[0], pairs[1], len(counts),
                                             device=device)
            return cluster_max_from_components(counts, indptr, indices, cc)
    return cluster_exact(counts, indptr, indices, maximum=maximum)


def overlap_unique(w: int) -> bool:
    """Whether a run of ``w``-lane words takes the overlapped pass 1 +
    unique route (:func:`_pass1_overlapped`): asked for by
    $HUMID_TPU_TORCH_OVERLAP_UNIQUE=1, and possible (words of at most two
    lanes, both host extensions built).  Off by default, as in the
    reference: it lost to the default route on the card's host (PERF.md).
    An opt-in that cannot engage keeps the fused route open."""
    return (w <= 2 and _merge_unique_runs is not None
            and _encode_pack is not None
            and os.environ.get(OVERLAP_ENV_VAR) == "1")


def _pass1_overlapped(files, nt_to_take, header_umi_size, batch_records,
                      cache: list | None, want_inverse: bool,
                      run_rows: int = 8 << 20, span_accs: list | None = None,
                      span=None, info: dict | None = None):
    """Pass 1 with unique counting folded in (words of at most two lanes;
    the reference's ``_pass1_overlapped``).  The packing jobs also emit
    (64-bit key, global read index) pairs of the usable reads; runs of
    ``run_rows`` keys are sorted on the same pool while the reader
    streams, and after the last batch one k-way merge
    (``_hostops.merge_unique_runs``) builds the unique table.

    Returns (total, usable, uniq [U, w] uint32, counts, first_occ (global
    read indices), inverse by read [total] (-1 for filtered reads) or
    None).  ``span`` (a :meth:`.PhaseLog.spans_under` callable) times the
    main thread's waits, and ``info`` counts the native UMI rows, as in
    :func:`_pass1`."""
    span = span or no_span
    w = W.num_lanes(header_umi_size + sum(nt_to_take))
    acc_k: list[np.ndarray] = []
    acc_i: list[np.ndarray] = []
    sort_futs: list = []
    state = {"total": 0, "acc_n": 0, "umi_native": 0}

    def _pack(batches, base):
        packed, filtered, umi_native = _batch_words(batches, nt_to_take,
                                                    header_umi_size)
        if filtered.any():
            keep = ~filtered
            keys = _combined_u64(packed[keep])
            gidx = base + np.flatnonzero(keep)
        else:
            keys = _combined_u64(packed)
            gidx = np.arange(base, base + len(packed), dtype=np.int64)
        spans = None
        if span_accs is not None:
            spans = [_span_batch_part(b, a["hdr_parts"] is not None)
                     if a["ok"] else None
                     for b, a in zip(batches, span_accs)]
        return keys, gidx, spans, umi_native

    def _sort_run(parts_k, parts_i):
        k, i = np.concatenate(parts_k), np.concatenate(parts_i)
        o = _stable_argsort_u64(k)
        return k[o], i[o]

    with ThreadPoolExecutor(max_workers=3) as ex:
        inflight: deque = deque()

        def _drain():
            # In submission order, so span stitching sees stream order.
            with span("wait pack"):
                keys, gidx, spans, umi_native = inflight.popleft().result()
            state["umi_native"] += umi_native
            if spans is not None:
                for part, acc in zip(spans, span_accs):
                    _span_stitch(part, acc)
            acc_k.append(keys)
            acc_i.append(gidx)
            state["acc_n"] += len(keys)
            if state["acc_n"] >= run_rows:
                sort_futs.append(ex.submit(_sort_run, list(acc_k),
                                           list(acc_i)))
                acc_k.clear()
                acc_i.clear()
                state["acc_n"] = 0

        for batches in _waited(read_tuples(files, batch_records,
                                           prefix_ks=nt_to_take), span):
            if cache is not None:
                cache.append(batches)
            inflight.append(ex.submit(_pack, batches, state["total"]))
            state["total"] += batches[0].n
            while len(inflight) > 4:
                _drain()
        while inflight:
            _drain()
        if state["acc_n"]:
            sort_futs.append(ex.submit(_sort_run, acc_k, acc_i))
        runs = [f.result() for f in sort_futs]

    if info is not None:
        info["umi_native_rows"] = state["umi_native"]
    total = state["total"]
    n_us = sum(len(r[0]) for r in runs)
    if not n_us:
        return (total, 0, np.zeros((0, w), np.uint32), np.zeros(0, np.int64),
                np.zeros(0, np.int64),
                np.full(total, -1, np.int64) if want_inverse else None)
    keys_cat = np.concatenate([r[0] for r in runs])
    idx_cat = np.concatenate([r[1] for r in runs])
    offs = np.cumsum([0] + [len(r[0]) for r in runs]).astype(np.int64)
    runs.clear()
    uk = np.empty(n_us, np.uint64)
    counts = np.empty(n_us, np.int64)
    first_occ = np.empty(n_us, np.int64)
    inv = (np.full(total, -1, np.int64) if want_inverse
           else np.empty(1, np.int64))
    k = _merge_unique_runs(keys_cat, idx_cat, offs, uk, counts, first_occ,
                           int(want_inverse), inv)
    uniq = np.empty((k, w), np.uint32)
    uniq[:, 0] = (uk[:k] >> np.uint64(32)).astype(np.uint32)
    if w == 2:
        uniq[:, 1] = uk[:k].astype(np.uint32)
    return (total, n_us, uniq, counts[:k].copy(), first_occ[:k].copy(),
            inv if want_inverse else None)


def _waited(batches, span):
    """``batches`` (an iterator) with each wait for the next item in the
    span "wait reader"."""
    it = iter(batches)
    while True:
        with span("wait reader"):
            item = next(it, None)
        if item is None:
            return
        yield item


def _pass1(files, nt_to_take, header_umi_size, batch_records,
           cache: list | None = None, pack_workers: int = 3,
           span_accs: list | None = None, feeder=None, span=None,
           info: dict | None = None):
    """Stream all files in lockstep; return (packed [N,W], filtered [N]).
    When ``cache`` is a list, parsed batch tuples are appended to it for
    reuse by the output pass.  When ``span_accs`` is given (one
    accumulator per file), absolute record spans are collected for the
    span-based dedup writer.  When ``feeder`` (an
    :class:`.ops.fused.DeviceFeeder`) is given, the usable packed rows go
    to the device during framing instead of collecting on the host, and
    the packed return value is None.

    Packing (UMI gather + base encode, all GIL-releasing C calls) runs on
    a small thread pool so it overlaps the reader thread's
    decompression + framing; in-flight futures are bounded so memory
    stays proportional to the pool size.

    ``span`` (a :meth:`.PhaseLog.spans_under` callable; None times
    nothing) names the main thread's waits: "wait reader" (the reader's
    queue), "wait pack" (a packing job) and "concat" (the final
    concatenations).  ``info`` (a dict, or None) receives
    "umi_native_rows": the rows whose UMI the native parse produced."""
    span = span or no_span
    packed_parts: list[np.ndarray] = []
    filt_parts: list[np.ndarray] = []
    umi_native_rows = 0

    def _work(batches):
        packed, filtered, umi_native = _batch_words(batches, nt_to_take,
                                                    header_umi_size)
        spans = None
        if span_accs is not None:
            # acc["ok"] read from the pool is GIL-safe; once a file's
            # accumulator is invalidated its span math is dead work.
            spans = [_span_batch_part(b, a["hdr_parts"] is not None)
                     if a["ok"] else None
                     for b, a in zip(batches, span_accs)]
        return packed, filtered, spans, umi_native

    def _drain(fut):
        # FIFO drain == submission order, so span stitching sees batches
        # in stream order.
        nonlocal umi_native_rows
        with span("wait pack"):
            packed, filtered, spans, umi_native = fut.result()
        umi_native_rows += umi_native
        if feeder is not None:
            # The feeder holds usable rows only (usable-index space).
            feeder.push(packed[~filtered] if filtered.any() else packed)
        else:
            packed_parts.append(packed)
        filt_parts.append(filtered)
        if spans is not None:
            for part, acc in zip(spans, span_accs):
                _span_stitch(part, acc)

    with ThreadPoolExecutor(max_workers=max(1, pack_workers)) as ex:
        inflight: deque = deque()
        for batches in _waited(read_tuples(files, batch_records,
                                           prefix_ks=nt_to_take), span):
            if cache is not None:
                cache.append(batches)
            inflight.append(ex.submit(_work, batches))
            while len(inflight) > pack_workers + 1:
                _drain(inflight.popleft())
        while inflight:
            _drain(inflight.popleft())
    if info is not None:
        info["umi_native_rows"] = umi_native_rows
    if feeder is not None:
        # The last flush can also find the budget short: raise here, inside
        # the caller's fallback.
        feeder.finish()
        with span("concat"):
            return None, (np.concatenate(filt_parts) if filt_parts
                          else np.zeros(0, bool))
    if not filt_parts:
        wl = header_umi_size + sum(nt_to_take)
        return (np.zeros((0, W.num_lanes(wl)), np.uint32),
                np.zeros(0, bool))
    with span("concat"):
        return np.concatenate(packed_parts), np.concatenate(filt_parts)


def run(
    files: list[str],
    *,
    word_length: int = 24,
    distance: int = 1,
    log_name: str = "/dev/stderr",
    dir_name: str = ".",
    run_stats: bool = False,
    write_dedup: bool = True,
    write_annotated: bool = False,
    maximum: bool = False,
    edit: bool = False,
    batch_records: int = 1 << 17,
    neighbor_opts: dict | None = None,
    cache_records: bool | None = None,
    device=None,
    profile_dir: str | None = None,
) -> PipelineResult:
    """Deduplicate ``files``; mirrors humid(wordLength, distance, ...)
    (humid.cc:369-409 and CLI defaults humid.cc:413-429); ``edit``
    selects Levenshtein distance (the -e flag) in place of Hamming
    distance.

    ``device`` (or HUMID_TPU_TORCH_DEVICE, default ``cuda``) is where the
    neighbour search runs; it is resolved before any input is read, and a
    CUDA request without CUDA raises DeviceUnavailableError.
    ``neighbor_opts`` are extra keyword arguments of
    :func:`humid_tpu_torch.ops.find_neighbor_pairs` (``strategy``,
    ``mesh``, ...).  What ran is returned in
    ``PipelineResult.extra["engine"]``: "unique" ("host", "device" or
    "fused"), what the search ran (metric, strategy, shard count,
    candidates, fallbacks), for -x "components", and "fused_fallback"
    (1 when the fused route was chosen but the reads did not fit it)
    where the fused route was chosen.

    The fused route (:mod:`.ops.fused`) is decided before pass 1, by
    :func:`humid_tpu_torch._backend.use_fused_pipeline`, for Hamming runs
    with ``distance >= 1`` and no ``neighbor_opts``,
    $HUMID_TPU_TORCH_STRATEGY, $HUMID_TPU_TORCH_IMPL,
    $HUMID_TPU_TORCH_UNIQUE or engaged overlapped route
    (:func:`overlap_unique`; "unique" is then "overlapped").

    ``profile_dir`` (or $HUMID_TPU_TORCH_PROFILE) wraps the whole run in
    ``torch.profiler`` (CPU activity, and CUDA on a CUDA device) and
    writes one Chrome trace, ``trace_<pid>.json``, into that directory;
    the phases and spans appear in it as ``record_function`` ranges.

    ``PipelineResult.extra["timings"]`` holds seconds by name, a name
    opened more than once summed (the tree in :mod:`.phaselog`).  The
    phases, which also write the ``-l`` log's lines: "Determing
    nucleotides to take", "Reading data", "Calculating neighbours using
    Hamming distance" (or "... Levenshtein distance"), "Calculating
    directional clusters" (or "Calculating maximum clusters"), "Writing
    filtered results", "Writing annotated results" and "Calculating
    count and neighbour stats" (around the statistics writer).  The
    spans, which write no log line: "run" (the root, with no profiler
    range), "set-up", "unique counting" (or "unique counting (fused)",
    or "unique counting (overlapped)" inside "Reading data"),
    "outputs"; below "Reading data" "Reading data/wait reader", ".../wait
    pack" and ".../concat"; below the neighbour phase ".../inputs",
    ".../upload", ".../wait K1", ".../pairs" (the dense sweep's steps)
    and ".../csr".  A route that skips a step has no span for it.
    """
    if not files:
        raise InputError("at least one FastQ file required")
    dev = resolve_device(device)
    if profile_dir is None:
        profile_dir = os.environ.get(PROFILE_ENV_VAR)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=activities) as prof:
            res = run(files, word_length=word_length, distance=distance,
                      log_name=log_name, dir_name=dir_name,
                      run_stats=run_stats, write_dedup=write_dedup,
                      write_annotated=write_annotated, maximum=maximum,
                      edit=edit, batch_records=batch_records,
                      neighbor_opts=neighbor_opts,
                      cache_records=cache_records, device=dev,
                      profile_dir="")
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(profile_dir, f"trace_{os.getpid()}.json"))
        return res
    log = PhaseLog(log_name)
    with log.span("run", in_trace=False):
        res = _run(log, dev, files, word_length=word_length,
                   distance=distance, dir_name=dir_name, run_stats=run_stats,
                   write_dedup=write_dedup, write_annotated=write_annotated,
                   maximum=maximum, edit=edit, batch_records=batch_records,
                   neighbor_opts=neighbor_opts, cache_records=cache_records)
    res.extra["timings"] = log.totals()
    log.close()
    return res


def _run(log: PhaseLog, dev, files, *, word_length, distance, dir_name,
         run_stats, write_dedup, write_annotated, maximum, edit,
         batch_records, neighbor_opts, cache_records) -> PipelineResult:
    """The body of :func:`run`, inside its root span: every step lies in
    a phase or a span of ``log`` (the tree in :mod:`.phaselog`)."""
    with log.span("set-up"):
        tune_malloc()  # scoped here, not at package import
        res = PipelineResult()

    # --- nucleotide budgeting (humid.cc:38-59) ---
    t = log.start("Determing nucleotides to take")
    umi_len = peek_umi_size(files[0])
    header_umi_size, nt_to_take = W.pre_compute(
        umi_len, len(files), word_length
    )
    log.end(t)

    with log.span("set-up"):
        log.write(f"  header: {header_umi_size}")
        for f, k in zip(files, nt_to_take):
            log.write(f"\n  {f}: {k}")
        log.write("\n")

        # --- pass 1: read + pack (readData, humid.cc:70-103) ---
        # Inputs up to 16GB parsed keep their record batches in memory so
        # the output pass skips the second read entirely (the reference
        # always re-reads, humid.cc:203-292).  The cap is deliberate even
        # on large-memory hosts: materializing tens of GB of fresh record
        # arrays costs first-touch page faults and page-cache eviction.
        cache: list | None = None
        if cache_records is None:
            cache_records = (_input_bytes_estimate(files)
                             < min(1 << 34, avail_bytes() // 3))
        if cache_records and (write_dedup or write_annotated):
            cache = []

        # Span cache: when the record cache does NOT fit but the inputs
        # are plain (mmap-able) files, collect absolute record spans
        # during pass 1 (8 bytes/record/file — plus 4 for header lengths
        # in annotate mode) so pass 2 copies record bytes from the mmap
        # instead of re-framing the whole input.
        # HUMID_TPU_TORCH_SPAN_CACHE=1 forces it (testing), =0 disables.
        span_env = os.environ.get("HUMID_TPU_TORCH_SPAN_CACHE")
        span_accs = None
        if ((write_dedup or write_annotated) and span_env != "0"
                and (cache is None or span_env == "1")
                and not any(is_gzip_file(f) for f in files)):
            if span_env == "1":
                cache = None  # force the span path end to end
            per_rec = 12 if write_annotated else 8
            budget = max(1 << 20, avail_bytes()
                         // (32 * max(len(files), 1)) // per_rec)
            span_accs = [_span_acc_new(budget, with_hdr=write_annotated)
                         for _ in files]

        engine = res.extra["engine"] = {}
        wl = header_umi_size + sum(nt_to_take)
        w = W.num_lanes(wl)
        overlapped = overlap_unique(w)
        feeder = None
        if (not edit and distance >= 1 and not neighbor_opts
                and not overlapped
                and not os.environ.get(STRATEGY_ENV_VAR)
                and not os.environ.get(IMPL_ENV_VAR)
                and not os.environ.get(UNIQUE_ENV_VAR)):
            from ._backend import use_fused_pipeline

            # The router weighs the routes at the estimate the feeder is
            # sized by: the reads are not counted yet.
            n_est = reads_estimate(files)
            if use_fused_pipeline(dev, n_est):
                from .ops.fused import DeviceFeeder, fused_fits

                engine["fused_fallback"] = int(
                    not fused_fits(n_est, w, dev))
                if not engine["fused_fallback"]:
                    feeder = DeviceFeeder(w, n_est, device=dev)

    t = log.start("Reading data")
    pass1_span = log.spans_under("Reading data")
    if feeder is not None:
        from .ops.fused import FusedCapacityExceeded

        try:
            _, filtered = _pass1(files, nt_to_take, header_umi_size,
                                 batch_records, cache, span_accs=span_accs,
                                 feeder=feeder, span=pass1_span, info=engine)
        except FusedCapacityExceeded:
            # The row estimate undershot: read again through the host
            # path with fresh caches (these saw only a prefix).
            feeder = None
            engine["fused_fallback"] = 1
            if cache is not None:
                cache.clear()
            if span_accs is not None:
                span_accs = [_span_acc_new(a["budget"],
                                           a["hdr_parts"] is not None)
                             for a in span_accs]
    fused = None
    if feeder is not None:
        from .ops.fused import FusedPipeline

        res.total = int(len(filtered))
        res.usable = int((~filtered).sum())
        log.end(t)
        with log.span("unique counting (fused)"):
            fused = FusedPipeline(feeder, res.total, filtered,
                                  word_length=wl, max_dist=distance,
                                  want_inverse=write_annotated,
                                  want_labels=maximum)
            res.unique = fused.unique()
            engine["unique"] = "fused"
        # Counts, first occurrences and the inverse are read after the
        # neighbour programs are launched; the table stays on the device.
    elif overlapped:
        # The read is the unique counting here: its span lies inside the
        # phase.
        with log.span("unique counting (overlapped)"):
            (res.total, res.usable, uniq, counts, first_occ,
             inv_by_read) = _pass1_overlapped(
                files, nt_to_take, header_umi_size, batch_records, cache,
                want_inverse=write_annotated, span_accs=span_accs,
                span=pass1_span, info=engine)
        log.end(t)
        engine["unique"] = "overlapped"
        res.unique = len(uniq)
    else:
        packed, filtered = _pass1(files, nt_to_take, header_umi_size,
                                  batch_records, cache, span_accs=span_accs,
                                  span=pass1_span, info=engine)
        res.total = int(len(packed))
        res.usable = int((~filtered).sum())
        log.end(t)

        # --- exact duplicate counting (replaces trie leaf counts) ---
        with log.span("unique counting"):
            any_filtered = bool(filtered.any())
            usable_packed = packed[~filtered] if any_filtered else packed
            # The row->unique inverse (and with it the per-read
            # cluster-id vector) is only needed for annotated output.
            uniq, counts, first_occ_usable, inverse = unique_words(
                usable_packed, want_inverse=write_annotated, device=dev,
                info=engine)
            # first_occ indexes usable rows; convert to global read
            # indices.
            if any_filtered:
                usable_to_read = np.flatnonzero(~filtered)
                first_occ = (usable_to_read[first_occ_usable]
                             if len(first_occ_usable) else first_occ_usable)
            else:
                usable_to_read = None  # identity mapping
                first_occ = first_occ_usable
            inv_by_read = None
            if write_annotated:
                inv_by_read = np.full(res.total, -1, np.int64)
                if res.total:
                    if any_filtered:
                        inv_by_read[usable_to_read] = inverse
                    else:
                        inv_by_read[:] = inverse
            res.unique = len(uniq)

    # --- neighbour search (humid.cc:113-158) ---
    phase = ("Calculating neighbours using Levenshtein distance" if edit
             else "Calculating neighbours using Hamming distance")
    t = log.start(phase)
    search_span = log.spans_under(phase)
    if fused is not None:
        pa, pb = fused.neighbors(info=engine)
        counts, first_occ, inv_by_read = fused.tables()
    else:
        pa, pb = find_neighbor_pairs(uniq, distance,
                                     metric="edit" if edit else "hamming",
                                     word_length=word_length, device=dev,
                                     info=engine, span=search_span,
                                     **(neighbor_opts or {}))
    res.counts = counts
    with search_span("csr"):
        indptr, indices = pairs_to_csr(pa, pb, res.unique)
        res.degree = np.diff(indptr)
    log.end(t)

    # --- clustering (humid.cc:167-193, cluster.cc) ---
    if maximum:
        t = log.start("Calculating maximum clusters")
    else:
        t = log.start("Calculating directional clusters")
    if fused is not None and maximum and fused.has_matches:
        # -x on the fused route: labels propagated over the resident match
        # masks (and the host's mid and big-run edges), ids finished on
        # the host.
        engine["components"] = "fused"
        cl = cluster_max_from_components(counts, indptr, indices,
                                         fused.device_labels())
    else:
        cl = cluster_dispatch(counts, indptr, indices, maximum=maximum,
                              pairs=(pa, pb), device=dev, info=engine)
    res.clusters = cl.num_clusters
    res.labels = cl.labels
    res.sizes = cl.size
    log.end(t)

    with log.span("outputs"):
        os.makedirs(dir_name, exist_ok=True)

        # Representative read per cluster: the first read (file order)
        # whose word is the cluster's maxLeaf (humid.cc:223-232).
        if cl.num_clusters:
            rep_reads = np.sort(first_occ[cl.max_leaf])
        else:
            rep_reads = np.zeros(0, np.int64)
        res.rep_reads = rep_reads

        # Per-read cluster id (0 for filtered reads; humid.cc:271-278),
        # only materialized for annotated output.  Filtered reads carry
        # inv_by_read == -1, which indexes the appended 0 sentinel.
        cluster_of_read = None
        if write_annotated:
            labels_ext = np.append(cl.labels, np.int64(0))
            cluster_of_read = labels_ext[inv_by_read]
        res.cluster_of_read = cluster_of_read

        # --- pass 2: outputs ---
        span_tables = _span_tables_from_accs(span_accs, res.total)
    if write_dedup:
        t = log.start("Writing filtered results")
        if span_tables is not None:
            _write_selected_spans(files, dir_name, "dedup", rep_reads,
                                  span_tables)
        else:
            _write_selected(files, dir_name, "dedup", rep_reads,
                            batch_records, cache)
        log.end(t)
    if write_annotated:
        t = log.start("Writing annotated results")
        if span_tables is not None and all(
                tb[2] is not None for tb in span_tables):
            _write_annotated_spans(
                files, make_file_names(list(files), dir_name, "annotated"),
                cluster_of_read, span_tables)
        else:
            _write_annotated(files, dir_name, cluster_of_read,
                             batch_records, cache)
        log.end(t)

    if run_stats:
        t = log.start("Calculating count and neighbour stats")
        write_statistics(
            counts=res.counts,
            degrees=res.degree,
            sizes=res.sizes,
            total=res.total,
            usable=res.usable,
            unique=res.unique,
            num_clusters=res.clusters,
            dir_name=dir_name,
        )
        log.end(t)
    return res


def part_final_name(name: str) -> str:
    """The final output name of a multi-process part file
    ``<final>.partNNNNN`` (any other name unchanged)."""
    return re.sub(r"\.part\d{5}$", "", name)


def _pipelined_write(source, names, build_one,
                     build_workers: int | None = None):
    """Drive an output pass with builds overlapped against writes.

    ``build_one(batches) -> list[np.ndarray]`` (one record buffer per
    file) runs on a thread pool (record assembly is GIL-releasing native
    gather); gzip outputs are also compressed on the pool, each batch
    becoming an independent gzip member (valid multi-member stream with
    byte-identical decompressed content).  The main thread writes
    completed payloads in order; bounded in-flight futures keep memory
    proportional to the pool size.
    """
    # Compression follows the final name: a multi-process part file
    # ("<final>.partNNNNN") hides its .gz suffix.
    writers = [FastqWriter(n, compress=part_final_name(n).endswith(".gz"))
               for n in names]
    if build_workers is None:
        # Gzip outputs spend their time in member compression — give
        # them the whole pool; plain outputs are gather-bound.
        build_workers = 4 if any(w.is_gz for w in writers) else 2

    def _build_and_pack(item):
        outs = build_one(item)
        return [
            compress_member(o, w.compression)
            if w.is_gz and len(o) else o
            for w, o in zip(writers, outs)
        ]

    def _flush(fut):
        for w, out in zip(writers, fut.result()):
            w.write_payload(out)

    try:
        with ThreadPoolExecutor(max_workers=build_workers) as ex:
            inflight: deque = deque()
            for batches in source:
                inflight.append(ex.submit(_build_and_pack, batches))
                while len(inflight) > build_workers + 1:
                    _flush(inflight.popleft())
            while inflight:
                _flush(inflight.popleft())
    finally:
        for w in writers:
            w.close()


def _write_selected(files, dir_name, suffix, selected, batch_records,
                    cache=None):
    """Second pass: write only reads whose global index is in ``selected``
    (sorted)."""
    names = make_file_names(list(files), dir_name, suffix)
    source = cache if cache is not None else read_tuples(
        files, batch_records)

    # Selection state advances per batch, so the plan (which records of
    # this batch are selected) is computed on the main thread during
    # submission; only the record assembly runs on the pool.
    state = {"base": 0, "ptr": 0}

    def _planned_source():
        for batches in source:
            n = batches[0].n
            base, ptr = state["base"], state["ptr"]
            end = int(np.searchsorted(selected, base + n, side="left"))
            local = (selected[ptr:end] - base).astype(np.int64)
            state["base"] = base + n
            state["ptr"] = end
            yield (batches, local)

    def _build_planned(item):
        batches, local = item
        return [build_records(b, local) for b in batches]

    _pipelined_write(_planned_source(), names, _build_planned)


def _span_tables_from_accs(span_accs, expected_entries: int):
    """[(starts_abs, end_sentinel, hdr_lens-or-None)] per file when
    every accumulator is valid and covers exactly ``expected_entries``
    records — None otherwise (the caller falls back to the re-reading
    writer)."""
    if span_accs is None or not all(
        a["ok"] and a["entries"] == expected_entries for a in span_accs
    ):
        return None
    return [
        (np.concatenate(a["parts"]) if a["parts"]
         else np.zeros(0, np.int64),
         a["base"],
         None if a["hdr_parts"] is None else
         (np.concatenate(a["hdr_parts"]) if a["hdr_parts"]
          else np.zeros(0, np.int32)))
        for a in span_accs
    ]


def _write_selected_spans(files, dir_name, suffix, selected, span_tables,
                          chunk: int = 1 << 19):
    """Second pass via cached record spans, to the reference-named
    outputs (:func:`_write_selected_spans_to`)."""
    _write_selected_spans_to(files, make_file_names(list(files), dir_name,
                                                    suffix),
                             selected, span_tables, chunk=chunk)


def _write_selected_spans_to(files, names, selected, span_tables,
                             chunk: int = 1 << 19):
    """Write the SELECTED records to ``names`` via cached record spans:
    mmap each (plain) input and concatenate only the selected records'
    raw bytes — no re-framing scan of the input.  Raw spans equal the
    canonical 4-line records because span collection verified LF-only
    line endings (``_span_batch_part``); a final record missing its
    trailing newline gets one appended, matching build_records."""
    fulls = []
    handles = []
    try:
        for f in files:
            fh = open(f, "rb")
            try:
                mm = _mmap.mmap(fh.fileno(), 0, prot=_mmap.PROT_READ)
            except ValueError:  # zero-byte file: nothing to select
                fh.close()
                fulls.append(np.zeros(0, np.uint8))
                continue
            handles.append((fh, mm))
            fulls.append(np.frombuffer(mm, np.uint8))

        def source():
            for lo in range(0, len(selected), chunk):
                yield selected[lo:lo + chunk]

        def build_one(sel):
            outs = []
            for full, (starts, total, _hdr) in zip(fulls, span_tables):
                s = starts[sel]
                e = np.empty(len(sel), np.int64)
                nxt = sel + 1
                inside = nxt < len(starts)
                e[inside] = starts[nxt[inside]]
                e[~inside] = total
                # A final record without a trailing newline spans one
                # byte past EOF (its raw length was counted with the
                # synthetic newline); clamp and emit the newline.
                nl_after = e > len(full)
                if nl_after.any():
                    np.minimum(e, len(full), out=e)
                outs.append(_build_output(full, s, e - s, nl_after))
            return outs

        _pipelined_write(source(), names, build_one)
    finally:
        fulls.clear()  # drop the numpy views of the maps first
        for fh, mm in handles:
            try:
                mm.close()
            except BufferError:  # a view outlived us; GC will close it
                pass
            fh.close()


def _write_annotated_spans(files, names, cluster_of_read, span_tables,
                           chunk: int = 1 << 19):
    """Annotated pass via cached record spans + header lengths: splice
    ``:<cluster_id>`` after each record's name line directly from an
    mmap of the (plain) input — no pass-2 re-framing.

    Per record three segments are emitted: the name line (no newline),
    the rendered ``:<id>``, and the raw remainder of the record starting
    at the name's newline — raw bytes equal the canonical record because
    span collection verified LF-only endings (``_span_batch_part``)."""
    n = len(cluster_of_read)
    fulls = []
    handles = []
    try:
        for f in files:
            fh = open(f, "rb")
            try:
                mm = _mmap.mmap(fh.fileno(), 0, prot=_mmap.PROT_READ)
            except ValueError:
                fh.close()
                fulls.append(np.zeros(0, np.uint8))
                continue
            handles.append((fh, mm))
            fulls.append(np.frombuffer(mm, np.uint8))

        def source():
            for lo in range(0, n, chunk):
                yield lo, min(n, lo + chunk)

        def build_one(rng):
            lo, hi = rng
            k = hi - lo
            ann_buf, ann_s, ann_l = _ann_buffer(cluster_of_read[lo:hi])
            outs = []
            for full, (starts, total, hdr) in zip(fulls, span_tables):
                s = starts[lo:hi]
                e = np.empty(k, np.int64)
                e[:-1] = starts[lo + 1:hi] if k > 1 else e[:0]
                e[-1] = starts[hi] if hi < len(starts) else total
                h = hdr[lo:hi].astype(np.int64)
                # The chunk's records are contiguous: copy their raw
                # byte range once, then gather segments relative to it.
                base = int(s[0]) if k else 0
                end = int(e[-1]) if k else 0
                nl_missing = end > len(full)  # unterminated final record
                if nl_missing:
                    end = len(full)
                src = np.concatenate([full[base:end], ann_buf])
                seg_start = np.empty((k, 3), np.int64)
                seg_len = np.empty((k, 3), np.int64)
                seg_start[:, 0] = s - base
                seg_len[:, 0] = h
                seg_start[:, 1] = (end - base) + ann_s
                seg_len[:, 1] = ann_l
                seg_start[:, 2] = s - base + h
                seg_len[:, 2] = e - s - h
                nl_after = np.zeros((k, 3), bool)
                if nl_missing:
                    seg_len[-1, 2] -= 1  # the counted synthetic newline
                    nl_after[-1, 2] = True
                outs.append(_build_output(src, seg_start.ravel(),
                                          seg_len.ravel(),
                                          nl_after.ravel()))
            return outs

        _pipelined_write(source(), names, build_one)
    finally:
        fulls.clear()
        for fh, mm in handles:
            try:
                mm.close()
            except BufferError:
                pass
            fh.close()


def _write_annotated(files, dir_name, cluster_of_read, batch_records,
                     cache=None):
    """Second pass: every read annotated with ``:<cluster_id>``
    (humid.cc:251-292)."""
    names = make_file_names(list(files), dir_name, "annotated")
    source = cache if cache is not None else read_tuples(
        files, batch_records)

    state = {"base": 0}

    def _planned_source():
        for batches in source:
            n = batches[0].n
            ids = cluster_of_read[state["base"]:state["base"] + n]
            state["base"] += n
            yield (batches, ids)

    def _build_planned(item):
        batches, ids = item
        return [build_records_annotated(b, ids) for b in batches]

    _pipelined_write(_planned_source(), names, _build_planned)
