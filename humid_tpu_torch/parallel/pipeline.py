"""The multi-process pipeline.

Counterpart of ``humid_tpu/parallel/pipeline.py``.  The single-process
building blocks compose into the data-parallel run:

  1. every process ingests its record range of every input file
     (lockstep, so tuples stay aligned) and packs its words;
  2. the per-process unique tables merge into the global table
     (:mod:`.multihost`): counts summed, the smallest first occurrence
     kept, so representative selection stays byte-exact;
  3. the neighbour search runs on the global table with each process
     computing its own share of the candidates on its device
     (``find_neighbor_pairs(shard=...)``, the engine agreed by broadcast),
     and the partial pair lists merge;
  4. clustering: replicated on every process, or (``_use_sharded_cluster``)
     over owned components (:mod:`.cluster`);
  5. every process writes the output records of its own range to part
     files; process 0 writes the statistics and, after a barrier,
     concatenates the parts into the reference-named outputs.

The same bytes as one process running :func:`humid_tpu_torch.run`.
``all_gather``/``barrier`` are injectable for in-process simulation;
under a real group (:func:`.multihost.init_distributed`) leave them None.

Environment:

  HUMID_TPU_TORCH_CLUSTER_SHARDED=1/0   force the sharded / replicated
                                        cluster phase
  HUMID_TPU_TORCH_SPAN_CACHE=0          no span-based dedup writer
  HUMID_TPU_TORCH_SCALING_REPORT=1      process 0 prints the scaling
                                        report on stderr
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from .. import words as W
from ..io import FastqWriter, build_records, build_records_annotated
from ..io import make_file_names, read_tuples
from ..io.reader import _open_stream, is_gzip_file, iter_chunk_newline_counts
from ..ops import find_neighbor_pairs, pairs_to_csr
from ..ops.unique import unique_words
from . import multihost as MH

#: Gate of the sharded cluster phase: a size floor and a process floor.
#: Each process's walk is ~1/P of the replicated one, but the shared
#: terms (components, ownership, the gather of the cluster rows, the
#: merge) are O(u + E + k) on every process, so it pays only at many
#: processes over large tables (the reference's gate, kept as it is).
#: HUMID_TPU_TORCH_CLUSTER_SHARDED=1/0 forces either way.
_SHARDED_CLUSTER_MIN_U = 1 << 22
_SHARDED_CLUSTER_MIN_HOSTS = 4

_COUNT_CHUNK = 32 * 1024 * 1024


def _final_line_content(data: bytes, tail_nonws: bool) -> bool:
    """Whether the unterminated final line (after ``data``) has content."""
    idx = data.rfind(b"\n")
    if idx < 0:
        return tail_nonws or bool(data.strip())
    return bool(data[idx + 1:].strip())


def _count_records_one(path: str) -> int:
    """Record count of one FastQ (any compression): line count // 4, the
    framer's rule (an unterminated final line closes a record only when
    it has non-whitespace content)."""
    stream = _open_stream(path)
    nl = 0
    tail_nonws = False
    try:
        for data, n in iter_chunk_newline_counts(stream):
            nl += n
            tail_nonws = _final_line_content(data, tail_nonws)
    finally:
        stream.close()
    return (nl + tail_nonws) // 4


def _scan_plain_counts(path: str):
    """Plain file: (record count, per-chunk newline counts); None for
    gzip.  The chunk table lets :func:`_offset_from_table` find any
    record's byte offset by reading one chunk."""
    if is_gzip_file(path):
        return None
    counts = []
    tail_nonws = False
    with open(path, "rb") as f:
        for data, n in iter_chunk_newline_counts(f, _COUNT_CHUNK):
            counts.append(n)
            tail_nonws = _final_line_content(data, tail_nonws)
    table = np.asarray(counts, np.int64)
    return (int(table.sum()) + tail_nonws) // 4, table


def _offset_from_table(path: str, k: int, chunk_counts: np.ndarray):
    """Byte offset of record ``k`` from the count scan's chunk table: the
    chunk holding the 4k-th newline, read again (page-cached)."""
    if k <= 0:
        return 0
    need = 4 * k
    cum = np.cumsum(chunk_counts)
    if len(cum) == 0 or need > int(cum[-1]):
        return None
    ci = int(np.searchsorted(cum, need))
    prev = int(cum[ci - 1]) if ci else 0
    with open(path, "rb") as f:
        f.seek(ci * _COUNT_CHUNK)
        buf = np.frombuffer(f.read(_COUNT_CHUNK), np.uint8)
    pos = int(np.flatnonzero(buf == ord("\n"))[need - prev - 1])
    return ci * _COUNT_CHUNK + pos + 1


def count_records_with_tables(files):
    """(lockstep tuple count, per-file chunk newline tables): the count is
    the minimum over files (the lockstep reader stops at the shortest,
    fastq.cc:41-43); for a plain file the same scan gives its chunk
    table, for a gzip file the table is None."""
    from concurrent.futures import ThreadPoolExecutor

    files = [files] if isinstance(files, str) else list(files)

    def one(f):
        d = _scan_plain_counts(f)
        return (_count_records_one(f), None) if d is None else d

    with ThreadPoolExecutor(max_workers=max(1, len(files))) as pool:
        results = list(pool.map(one, files))
    return min(n for n, _ in results), [t for _, t in results]


def count_records(files) -> int:
    """Number of lockstep record tuples across ``files`` (a raw newline
    scan per file, not a framing pass)."""
    return count_records_with_tables(files)[0]


def _spill_gz_range(path: str, lo: int, hi: int, spill_path: str):
    """Inflate a gzip FastQ once, writing the bytes of records [lo, hi)
    into a sparse plain file at their stream-absolute offsets, and stop
    right after record ``hi``: processes early in the file inflate less,
    and none frames, packs or rereads bytes outside its range.  The
    sparse layout keeps absolute offsets, so the offset and span
    machinery of plain inputs applies unchanged.  Returns (start, end)
    offsets of the range (end = the spill's apparent size)."""
    need_lo, need_hi = 4 * lo, 4 * hi
    seen = base = 0
    started = lo == 0
    start_off = 0 if started else None
    end_off = None
    stream = _open_stream(path)
    out = open(spill_path, "wb")
    try:
        for data, n in iter_chunk_newline_counts(stream):
            s_in = 0
            if not started:
                if seen + n >= need_lo:
                    buf = np.frombuffer(data, np.uint8)
                    pos = int(np.flatnonzero(buf == 10)[need_lo - seen - 1])
                    start_off = base + pos + 1
                    s_in = pos + 1
                    started = True
                    out.seek(start_off)
                else:
                    seen += n
                    base += len(data)
                    continue
            if seen + n >= need_hi:
                buf = np.frombuffer(data, np.uint8)
                pos = int(np.flatnonzero(buf == 10)[need_hi - seen - 1])
                end_off = base + pos + 1
                out.write(data[s_in:pos + 1])
                break
            out.write(data[s_in:])
            seen += n
            base += len(data)
        else:
            # End of stream before the hi-th record boundary: the range
            # ends there (an unterminated final record, or fewer records).
            end_off = base
            if start_off is None:
                start_off = base
        out.truncate(end_off)  # apparent size = range end, even if empty
    finally:
        out.close()
        stream.close()
    return start_off, end_off


def spill_gz_ranges(files, lo: int, hi: int, tables):
    """Spill every gzip input's [lo, hi) range to a private scratch
    directory; plain files pass through, their offsets from their count
    scan ``tables`` (:func:`count_records_with_tables`).  Returns (local
    files, start offsets, the directory); the caller removes the
    directory."""
    spill_dir = tempfile.mkdtemp(prefix="humid_tpu_torch_gzspill_")
    files_local = list(files)
    offs = []
    try:
        for i, f in enumerate(files):
            if tables[i] is None:
                sp = os.path.join(
                    spill_dir, f"spill{i:03d}_{os.path.basename(f)}.plain")
                offs.append(_spill_gz_range(f, lo, hi, sp)[0])
                files_local[i] = sp
            else:
                offs.append(_offset_from_table(f, lo, tables[i]))
        return files_local, offs, spill_dir
    except BaseException:
        shutil.rmtree(spill_dir, ignore_errors=True)
        raise


def pack_host_range(files, lo: int, hi: int, *, word_length: int = 24,
                    start_offsets=None, span_accs=None):
    """Packed words of record tuples [lo, hi) of every file: (packed
    [n, W], filtered [n]), local indices (add ``lo`` for global read
    indices).  ``start_offsets`` starts framing at record ``lo``;
    ``span_accs`` (one per file, bases preset to record lo's offset)
    collect the range's absolute record spans for the span writers."""
    from ..pipeline import (_batch_words, _span_batch_part, _span_stitch,
                            peek_umi_size)

    header_umi_size, nt_to_take = W.pre_compute(
        peek_umi_size(files[0]), len(files), word_length)
    shift = lo if start_offsets is not None else 0
    packed_parts, filt_parts = [], []
    base = 0
    for batches in read_tuples(files, start_offsets=start_offsets):
        n = batches[0].n
        s = max((lo - shift) - base, 0)
        e = min((hi - shift) - base, n)
        base += n
        if e > s:
            sub = [b.slice_records(s, e) for b in batches]
            if span_accs is not None:
                for b, acc in zip(sub, span_accs):
                    _span_stitch(_span_batch_part(
                        b, acc["hdr_parts"] is not None), acc)
            packed, filtered = _batch_words(sub, nt_to_take,
                                            header_umi_size)
            packed_parts.append(packed)
            filt_parts.append(filtered)
        if base >= hi - shift:
            break
    if not packed_parts:
        wl = header_umi_size + sum(nt_to_take)
        return (np.zeros((0, W.num_lanes(wl)), np.uint32),
                np.zeros(0, bool))
    return np.concatenate(packed_parts), np.concatenate(filt_parts)


def _use_sharded_cluster(u: int, n_proc: int) -> bool:
    env = os.environ.get("HUMID_TPU_TORCH_CLUSTER_SHARDED")
    if env in ("0", "1"):
        return env == "1"
    return u >= _SHARDED_CLUSTER_MIN_U and n_proc >= _SHARDED_CLUSTER_MIN_HOSTS


def _compute_sharded(files, *, word_length: int = 24, distance: int = 1,
                     edit: bool = False, maximum: bool = False,
                     process_id: int | None = None,
                     num_processes: int | None = None, all_gather=None,
                     neighbor_opts: dict | None = None,
                     collect_spans: bool = False, collect_hdr: bool = False,
                     device=None):
    """The compute stage of the multi-process pipeline: the global
    clustering, this process's local arrays for the output stage, the
    search's ``engine`` record and per-phase wall seconds (the scaling
    report's input)."""
    from .._util import avail_bytes
    from ..pipeline import (_span_acc_new, _span_tables_from_accs,
                            cluster_dispatch)

    timings: dict[str, float] = {}
    t0 = time.perf_counter()

    def mark(phase: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        timings[phase] = timings.get(phase, 0.0) + (now - t0)
        t0 = now

    n_proc = num_processes if num_processes is not None else \
        MH.process_count()
    p = process_id if process_id is not None else MH.process_index()
    sharded = n_proc > 1
    if sharded and all_gather is None:
        if MH.process_count() != n_proc:
            raise RuntimeError(
                f"num_processes={n_proc} but the process group has "
                f"{MH.process_count()} and no all_gather was given; call "
                "multihost.init_distributed (CLI: --coordinator) or the "
                "merge would use this process's table alone")
        all_gather = MH.default_all_gather
    dev = MH.process_device(device, p)
    total_records, tables = count_records_with_tables(files)
    lo, hi = MH.host_record_range(total_records, p, n_proc)
    files_local, start_offsets, spill_dir = list(files), None, None
    if sharded and any(t is None for t in tables):
        # Each gzip input's [lo, hi) goes to a sparse plain spill in one
        # inflate that stops at the range end; framing, packing, spans
        # and the output pass then run on the spill.
        files_local, start_offsets, spill_dir = spill_gz_ranges(
            files, lo, hi, tables)
        # The spill's time grows with the range end (the last process
        # inflates everything): absorb the skew before the first gather.
        MH.coordination_barrier("gz_spill")
    elif all(t is not None for t in tables):
        start_offsets = [_offset_from_table(f, lo, t)
                         for f, t in zip(files, tables)]
    span_accs = None
    if (collect_spans
            and os.environ.get("HUMID_TPU_TORCH_SPAN_CACHE") != "0"
            and start_offsets is not None):
        budget = max(1 << 20, avail_bytes() // (32 * max(len(files), 1)) // 8)
        span_accs = [_span_acc_new(budget, with_hdr=collect_hdr)
                     for _ in files]
        for acc, off in zip(span_accs, start_offsets):
            acc["base"] = off
    mark("range_setup")
    packed, filtered = pack_host_range(
        files_local, lo, hi, word_length=word_length,
        start_offsets=start_offsets, span_accs=span_accs)
    mark("pack")
    usable = packed[~filtered]
    local_to_read = np.flatnonzero(~filtered) + lo
    uniq_l, counts_l, first_l, _ = unique_words(usable, want_inverse=False,
                                                device=dev)
    first_global = local_to_read[first_l] if len(first_l) else first_l
    mark("unique_local")
    if sharded:
        uniq, counts, first_occ = MH.merge_unique_tables(
            uniq_l, counts_l, first_global, all_gather=all_gather)
    else:
        uniq, counts, first_occ = uniq_l, counts_l, first_global
    mark("unique_merge")

    nb = dict(neighbor_opts or {})
    engine: dict = {}
    if sharded:
        # Each process computes its ~1/P share of the candidates; the
        # partial pair lists merge below.
        nb.setdefault("shard", (p, n_proc))
        if edit and "join_cap" not in nb:
            # The join cap defaults from this process's free memory, but
            # exceeding it switches the partitioning (shifted joins ->
            # dense stripes): every process must take that together.
            from ..ops.neighbors import default_join_cap

            (caps,) = all_gather([np.asarray([default_join_cap()],
                                             np.int64)])
            nb["join_cap"] = min(int(np.asarray(c).ravel()[0]) for c in caps)
        if (not edit and "strategy" not in nb
                and not os.environ.get("HUMID_TPU_TORCH_STRATEGY")):
            # Every process runs the engine process 0's router picks (an
            # explicit or environment strategy is the same everywhere).
            nb["strategy"] = MH.broadcast_engine_choice(
                u=len(uniq), device=dev, all_gather=all_gather,
                process_id=p)
    pa, pb = find_neighbor_pairs(
        uniq, distance, metric="edit" if edit else "hamming",
        word_length=word_length, device=dev, info=engine, **nb)
    if sharded:
        engine["pairs_local"] = len(pa)
        pa, pb = MH.merge_edge_lists(pa, pb, all_gather=all_gather)
    mark("neighbors")
    indptr, indices = pairs_to_csr(pa, pb, len(uniq))
    if sharded and _use_sharded_cluster(len(uniq), n_proc):
        from .cluster import cluster_sharded

        engine["cluster"] = "sharded"
        cl = cluster_sharded(counts, indptr, indices, pa, pb,
                             maximum=maximum, shard=(p, n_proc),
                             all_gather=all_gather, device=dev)
    else:
        engine["cluster"] = "replicated"
        cl = cluster_dispatch(counts, indptr, indices, maximum=maximum,
                              pairs=(pa, pb), device=dev, info=engine)
    mark("cluster")
    return dict(
        cl=cl, counts=counts, first_occ=first_occ, uniq=uniq,
        indptr=indptr, lo=lo, hi=hi, filtered=filtered, usable=usable,
        total_records=total_records, n_proc=n_proc, process_id=p,
        start_offsets=start_offsets,
        span_tables=_span_tables_from_accs(span_accs, hi - lo),
        files_local=files_local, spill_dir=spill_dir, timings=timings,
        engine=engine, gather=all_gather)


def run_sharded(files, *, word_length: int = 24, distance: int = 1,
                edit: bool = False, maximum: bool = False,
                process_id: int | None = None,
                num_processes: int | None = None, all_gather=None,
                neighbor_opts: dict | None = None, device=None):
    """Host-sharded dedup without outputs: this process packs its record
    range, the tables merge, and the global clustering is computed.
    Returns (ClusterResult, counts [U], first_occ [U] global read indices,
    uniq [U, W]): the same on every process, and the same as one process
    over the whole input."""
    st = _compute_sharded(
        files, word_length=word_length, distance=distance, edit=edit,
        maximum=maximum, process_id=process_id,
        num_processes=num_processes, all_gather=all_gather,
        neighbor_opts=neighbor_opts, device=device)
    if st["spill_dir"]:
        shutil.rmtree(st["spill_dir"], ignore_errors=True)
    return st["cl"], st["counts"], st["first_occ"], st["uniq"]


def _part_names(names, process_id: int):
    return [f"{n}.part{process_id:05d}" for n in names]


def _part_writers(names):
    """Writers of part files: gzip follows the final name."""
    from ..pipeline import part_final_name

    return [FastqWriter(n, compress=part_final_name(n).endswith(".gz"))
            for n in names]


def _range_batches(files, lo, hi, batch_records, start_offsets):
    """(local offset of the slice, sliced batch tuple) over records
    [lo, hi) of ``files``."""
    shift = lo if start_offsets is not None else 0
    base = 0
    for batches in read_tuples(files, batch_records,
                               start_offsets=start_offsets):
        n = batches[0].n
        s = max((lo - shift) - base, 0)
        e = min((hi - shift) - base, n)
        if e > s:
            yield base + s - (lo - shift), [b.slice_records(s, e)
                                            for b in batches]
        base += n
        if base >= hi - shift:
            return


def _write_range_selected(files, names, selected_local, lo, hi,
                          batch_records, start_offsets=None):
    """Write the records of [lo, hi) whose local index is in
    ``selected_local`` (sorted) to ``names`` (one writer per file)."""
    writers = _part_writers(names)
    ptr = 0
    try:
        for off, sub in _range_batches(files, lo, hi, batch_records,
                                       start_offsets):
            end = int(np.searchsorted(selected_local, off + sub[0].n))
            loc = (selected_local[ptr:end] - off).astype(np.int64)
            for b, w in zip(sub, writers):
                w.write_array(build_records(b, loc))
            ptr = end
    finally:
        for w in writers:
            w.close()


def _write_range_annotated(files, names, cluster_of_local, lo, hi,
                           batch_records, start_offsets=None):
    """Write every record of [lo, hi) with ``:<cluster_id>`` appended."""
    writers = _part_writers(names)
    try:
        for off, sub in _range_batches(files, lo, hi, batch_records,
                                       start_offsets):
            ids = cluster_of_local[off:off + sub[0].n]
            for b, w in zip(sub, writers):
                w.write_array(build_records_annotated(b, ids))
    finally:
        for w in writers:
            w.close()


def finalize_outputs(names, num_processes: int) -> None:
    """Concatenate the part files into the final outputs (process 0,
    after the output barrier).  Plain parts concatenate to the bytes of a
    single-process run; gzip parts make a valid multi-member gzip with
    the same decompressed content.  Each output is written under a
    private name and renamed, so no reader sees a half-written file."""
    for name in names:
        tmp = f"{name}.{os.getpid()}.tmp"
        with open(tmp, "wb") as out:
            for p in range(num_processes):
                with open(f"{name}.part{p:05d}", "rb") as src:
                    shutil.copyfileobj(src, out, 1 << 24)
        os.replace(tmp, name)
        for p in range(num_processes):
            os.remove(f"{name}.part{p:05d}")


#: Gather order of the per-process phase timings (the scaling report's
#: wire format; every process agrees on it).
_SCALING_PHASES = ("range_setup", "pack", "unique_local", "unique_merge",
                   "neighbors", "cluster", "write_dedup", "write_annotated")

#: The last scaling report computed by run_distributed in this process.
LAST_SCALING_REPORT: dict = {}

#: The search's record of the last run_distributed in this process (the
#: ``info`` of find_neighbor_pairs, "pairs_local" and "cluster").
LAST_ENGINE: dict = {}


def scaling_report(per_host, n_proc: int) -> dict:
    """Scaling summary from per-process per-phase wall seconds
    (``per_host`` [n_proc, len(_SCALING_PHASES)]).  Processes run the
    phases in lockstep around the gathers, so a phase's critical path is
    its slowest process:

      wall        = sum over phases of the max over processes
      total_work  = sum of all entries
      efficiency  = total_work / (n_proc * wall)

    1.0 is perfectly balanced work; imbalance and replicated work (the
    replicated cluster phase) pull it down, and the per-phase
    efficiencies show where."""
    per_host = np.asarray(per_host, np.float64)
    n_proc = int(n_proc)
    phase_max = per_host.max(axis=0)
    phase_sum = per_host.sum(axis=0)
    wall = float(phase_max.sum())
    total_work = float(phase_sum.sum())
    phases = {}
    for i, name in enumerate(_SCALING_PHASES):
        if phase_max[i] <= 0:
            continue
        phases[name] = {
            "max_s": round(float(phase_max[i]), 4),
            "sum_s": round(float(phase_sum[i]), 4),
            "efficiency": round(
                float(phase_sum[i]) / (n_proc * float(phase_max[i])), 4),
        }
    return {
        "n_hosts": n_proc,
        "wall_s": round(wall, 4),
        "total_work_s": round(total_work, 4),
        "efficiency": round(total_work / (n_proc * wall), 4)
        if wall > 0 else 1.0,
        "phases": phases,
        "per_host_s": [[round(float(v), 4) for v in row] for row in per_host],
    }


def run_distributed(files, *, word_length: int = 24, distance: int = 1,
                    log_name: str = "/dev/stderr", dir_name: str = ".",
                    run_stats: bool = False, write_dedup: bool = True,
                    write_annotated: bool = False, edit: bool = False,
                    maximum: bool = False, process_id: int | None = None,
                    num_processes: int | None = None, all_gather=None,
                    barrier=None, finalize: bool = True,
                    batch_records: int = 1 << 17,
                    neighbor_opts: dict | None = None, device=None):
    """The whole multi-process run: the sharded compute, then each
    process writes the dedup/annotated records of its own range to part
    files, process 0 writes the statistics and, after a barrier,
    concatenates the parts into the reference-named outputs: the files
    :func:`humid_tpu_torch.run` writes (humid.cc:203-292).

    ``device`` is resolved per process (:func:`.multihost.process_device`:
    a bare ``cuda`` takes card ``process_id % cards``).  Returns
    (ClusterResult with the full [U] labels, counts [U], first_occ [U],
    uniq [U, W]), the same on every process.  :data:`LAST_SCALING_REPORT`
    holds the scaling report and ``LAST_ENGINE`` the search's record."""
    from .._util import tune_malloc
    from ..phaselog import PhaseLog
    from ..stats import write_statistics

    tune_malloc()
    p = process_id if process_id is not None else MH.process_index()
    log = PhaseLog(log_name if p == 0 else os.devnull)
    t = log.start("Reading data")
    st = _compute_sharded(
        files, word_length=word_length, distance=distance, edit=edit,
        maximum=maximum, process_id=p,
        num_processes=num_processes, all_gather=all_gather,
        neighbor_opts=neighbor_opts,
        collect_spans=write_dedup or write_annotated,
        collect_hdr=write_annotated, device=device)
    log.end(t)
    cl, counts, first_occ = st["cl"], st["counts"], st["first_occ"]
    lo, hi, n_proc = st["lo"], st["hi"], st["n_proc"]
    LAST_ENGINE.clear()
    LAST_ENGINE.update(st["engine"])
    files_local = st["files_local"]

    # Representative read per cluster (humid.cc:223-232).
    rep_reads = (np.sort(first_occ[cl.max_leaf]) if cl.num_clusters
                 else np.zeros(0, np.int64))
    cluster_of_local = None
    if write_annotated:
        # Per-read cluster ids of the range (0 = filtered, humid.cc:271-278).
        cluster_of_local = np.zeros(hi - lo, np.int64)
        if len(st["usable"]):
            from .multihost import global_unique_index

            cluster_of_local[np.flatnonzero(~st["filtered"])] = cl.labels[
                global_unique_index(st["uniq"], st["usable"])]

    os.makedirs(dir_name, exist_ok=True)
    dedup_names = make_file_names(list(files), dir_name, "dedup")
    ann_names = make_file_names(list(files), dir_name, "annotated")
    spans = st["span_tables"]
    if write_dedup:
        t = log.start("Writing filtered results")
        tw = time.perf_counter()
        sel = rep_reads[(rep_reads >= lo) & (rep_reads < hi)] - lo
        if spans is not None:
            from ..pipeline import _write_selected_spans_to

            _write_selected_spans_to(files_local, _part_names(dedup_names, p),
                                     sel, spans)
        else:
            _write_range_selected(files_local, _part_names(dedup_names, p),
                                  sel, lo, hi, batch_records,
                                  start_offsets=st["start_offsets"])
        st["timings"]["write_dedup"] = time.perf_counter() - tw
        log.end(t)
    if write_annotated:
        t = log.start("Writing annotated results")
        tw = time.perf_counter()
        if spans is not None and all(tb[2] is not None for tb in spans):
            from ..pipeline import _write_annotated_spans

            _write_annotated_spans(files_local, _part_names(ann_names, p),
                                   cluster_of_local, spans)
        else:
            _write_range_annotated(files_local, _part_names(ann_names, p),
                                   cluster_of_local, lo, hi, batch_records,
                                   start_offsets=st["start_offsets"])
        st["timings"]["write_annotated"] = time.perf_counter() - tw
        log.end(t)
    if n_proc > 1:
        # Every process's phase seconds, over the same gather.
        mine = np.array([st["timings"].get(k, 0.0) for k in _SCALING_PHASES],
                        np.float64)
        (rows,) = st["gather"]([mine])
        report = scaling_report(np.stack([np.asarray(r, np.float64)
                                          for r in rows]), n_proc)
        LAST_SCALING_REPORT.clear()
        LAST_SCALING_REPORT.update(report)
        if p == 0 and os.environ.get("HUMID_TPU_TORCH_SCALING_REPORT"):
            print("humid_tpu_torch scaling report: " + json.dumps(report),
                  file=sys.stderr)
    if st["spill_dir"]:
        shutil.rmtree(st["spill_dir"], ignore_errors=True)
    if run_stats and p == 0:
        write_statistics(counts=counts, degrees=np.diff(st["indptr"]),
                         sizes=cl.size, total=st["total_records"],
                         usable=int(counts.sum()), unique=len(counts),
                         num_clusters=cl.num_clusters, dir_name=dir_name)
    if n_proc > 1:
        if barrier is None and MH.process_count() == 1:
            # Injected gathers and no barrier: process 0 cannot know that
            # the others have written their parts, so an external
            # finalize_outputs() call joins them.
            log.close()
            return cl, counts, first_occ, st["uniq"]
        (barrier if barrier is not None else MH.default_barrier)()
    if finalize and p == 0:
        finalize_outputs((dedup_names if write_dedup else [])
                         + (ann_names if write_annotated else []), n_proc)
    log.close()
    return cl, counts, first_occ, st["uniq"]

