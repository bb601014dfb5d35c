"""Fused device-resident route: unique counting, the pigeonhole partitions,
the in-run sweeps and the -x labels against one copy of the reads on the
device.

The phase-wise device engines each pay their own transfers: device unique
counting ships the reads up and the table down, the device runs engine
ships the table up again (it is this route from program B on:
:meth:`FusedPipeline.from_table`), and device components ship the pairs
up once more.  Here:

* packed read batches go up while pass 1 is still framing
  (:class:`DeviceFeeder`: pinned staging buffers, copies on a side
  stream, one resident buffer);
* program A sorts and groups the reads where they are
  (:func:`humid_tpu_torch.ops.unique._unique_program`); the unique table
  stays on the device;
* program B sorts the table by each pigeonhole segment and finds the runs
  (:func:`_fused_partitions`), so no host sort and no order upload;
* program C runs the offset-shift in-run sweeps against the resident
  table (:func:`.runs_device._runs_eval`), the base offsets launched
  before the host has read the run-length histogram;
* for -x, program D propagates component labels over the resident match
  masks plus the host-enumerated mid and big-run edges
  (:func:`_fused_labels`);
* the host reads the device in bundles: k, then the run bitmaps with the
  histogram, then the match bitmaps, then counts, first occurrences and
  the inverse.

Candidates are those of the runs engines (pigeonhole completeness,
humid.cc:113-130): runs of up to d_max + 1 rows by the device sweeps,
longer ones by the host's :func:`.neighbors.enumerate_run_pairs`, runs
longer than ``run_cap`` by the Hamming tile sweep with its run-id mask
(:func:`.neighbors._big_run_pairs`), giant ones by the dense sweep: the
deduplicated pairs equal the host engine's.

Counterpart of ``humid_tpu/ops/fused.py`` (programs A-D are ``jax.jit``
programs there, PyTorch ops here).  Routing:
:func:`humid_tpu_torch._backend.use_fused_pipeline`.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device, to_device, to_host
from .._util import avail_bytes, concat_aranges
from .runs_device import (_bitmap_positions, _round_up, _runs_eval,
                          pack_bits, segment_lane_masks)
from .unique import _lex_order, _unique_program


class FusedCapacityExceeded(RuntimeError):
    """The feeder would have to grow past the device's budget (the row
    estimate before the run undershot): the pipeline reads the input
    again through the host path instead."""


def fused_fits(n_rows: int, w: int, device) -> bool:
    """Whether ``n_rows`` reads of ``w`` lanes fit the fused route within
    three quarters of the device's free memory (on the CPU: of the host's
    available memory).  Program A is the high-water mark: the resident
    buffer, the sorted copy and the table (4w bytes a row each), the int64
    sort keys, indices and sort scratch, group ids, counts, first
    occurrences and the inverse (about 112 bytes a row)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        budget = torch.cuda.mem_get_info(dev)[0]
    else:
        budget = avail_bytes()
    need = _round_up(max(int(n_rows), 1), 32) * (12 * int(w) + 112)
    return need < 0.75 * budget


class DeviceFeeder:
    """Collects the usable packed reads into one resident [cap, w] int32
    tensor on ``device``, row index = usable-read index (the caller pushes
    filtered batches in stream order).  Rows are staged on the host and
    sent in chunks of ``chunk_rows``: on a CUDA device through two pinned
    buffers, each copy ``non_blocking`` on a side stream and an event per
    buffer that the host waits for before it fills that buffer again, so
    the copies overlap pass 1.  Unwritten rows are all ones (they sort
    after every read); the buffer doubles when the estimate was short."""

    def __init__(self, w: int, n_est: int, *, device=None,
                 chunk_rows: int = 1 << 22):
        self.w = int(w)
        self.device = resolve_device(device)
        self.chunk = max(int(chunk_rows), 256)
        self.cap = _round_up(max(int(n_est), self.chunk), 32)
        self.buf = torch.full((self.cap, self.w), -1, dtype=torch.int32,
                              device=self.device)
        self.n = 0  # usable rows sent (the next row's index)
        self._stage: list[np.ndarray] = []
        self._staged = 0
        self._done = False
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            self.buf.record_stream(self._stream)
            self._pinned: list = [None, None]  # allocated at first use
            self._events: list = [None, None]
            self._next = 0

    def push(self, packed: np.ndarray) -> None:
        if self._done:
            raise RuntimeError("push after finish")
        if len(packed):
            self._stage.append(packed)
            self._staged += len(packed)
        while self._staged >= self.chunk:
            self._flush(self.chunk)

    def _take(self, out: np.ndarray) -> None:
        """Move the first len(out) staged rows into ``out`` ([rows, w]
        uint32)."""
        got = 0
        while got < len(out):
            packed = self._stage[0]
            take = min(len(out) - got, len(packed))
            out[got:got + take] = packed[:take]
            if take == len(packed):
                self._stage.pop(0)
            else:
                self._stage[0] = packed[take:]
            got += take
        self._staged -= len(out)

    def _ensure_cap(self, need_rows: int) -> None:
        while self.n + need_rows > self.cap:
            if not fused_fits(2 * self.cap, self.w, self.device):
                raise FusedCapacityExceeded(
                    f"the feeder would grow to {2 * self.cap} rows, past the "
                    f"device budget (the row estimate undershot)")
            new = torch.full((2 * self.cap, self.w), -1, dtype=torch.int32,
                             device=self.device)
            if self._cuda:
                # After the fill and after every copy into the old buffer.
                self._stream.wait_stream(torch.cuda.current_stream(
                    self.device))
                new.record_stream(self._stream)
                with torch.cuda.stream(self._stream):
                    new[:self.cap].copy_(self.buf)
            else:
                new[:self.cap] = self.buf
            self.buf = new
            self.cap *= 2

    def _flush(self, rows: int) -> None:
        self._ensure_cap(rows)
        dst = self.buf[self.n:self.n + rows]
        if self._cuda:
            i = self._next
            self._next ^= 1
            if self._events[i] is not None:
                self._events[i].synchronize()  # its last copy has landed
            if self._pinned[i] is None:
                self._pinned[i] = torch.empty((self.chunk, self.w),
                                              dtype=torch.int32,
                                              pin_memory=True)
            host = self._pinned[i][:rows]
            self._take(host.numpy().view(np.uint32))
            with torch.cuda.stream(self._stream):
                dst.copy_(host, non_blocking=True)
                self._events[i] = torch.cuda.Event()
                self._events[i].record(self._stream)
        else:
            host = np.empty((rows, self.w), np.uint32)
            self._take(host)
            dst.copy_(torch.from_numpy(host.view(np.int32)))
        self.n += rows

    def finish(self) -> torch.Tensor:
        """Send the staged remainder and return the buffer, ordered on the
        current stream after every copy."""
        if not self._done:
            if self._staged:
                self._flush(self._staged)
            if self._cuda:
                torch.cuda.current_stream(self.device).wait_stream(
                    self._stream)
            self._done = True
        return self.buf


def _fused_partitions(table: torch.Tensor, k: int, seg_masks: np.ndarray,
                      *, d_cap: int, run_cap: int):
    """Program B: each pigeonhole partition's sorted order and run
    structure over the resident table.

    table: [u_pad, w] int32, rows < k the ascending unique words, the rest
    all ones (they sort after every real row of equal segment, so the
    first k sorted positions are real).  Returns
      orders  [n_seg - 1, u_pad] int64 (partition 0 is the identity),
      runbits [n_seg, u_pad / 8] uint8 run-start flags (:func:`pack_bits`),
      hist    [d_cap + 2] int64 rows of runs of 2..run_cap rows by
              min(length - 1, d_cap + 1),
      big     [n_seg] int64 rows in runs longer than ``run_cap``;
    run lengths count real rows only.  No host synchronisation."""
    u_pad, w = table.shape
    dev = table.device
    masks = to_device(seg_masks.view(np.int32), dev)
    iota = torch.arange(u_pad, device=dev)
    hist = torch.zeros(d_cap + 2, dtype=torch.int64, device=dev)
    orders, runbits, bigs = [], [], []
    for p in range(len(seg_masks)):
        # A segment's bases are contiguous, so are its lanes: a slice
        # (indexing by a list would copy the list to the device, a wait).
        cols = np.flatnonzero(seg_masks[p])
        lo, hi = (int(cols[0]), int(cols[-1]) + 1) if len(cols) else (0, 0)
        mk = table[:, lo:hi] & masks[p, lo:hi]
        if p == 0:
            order = iota
        else:
            # An empty segment (more segments than bases) keys every row
            # alike: one run, in table order.
            order = _lex_order(mk) if hi > lo else iota
            mk = mk[order]
            orders.append(order)
        new = torch.ones(u_pad, dtype=torch.bool, device=dev)
        new[1:] = (mk[1:] != mk[:-1]).any(dim=1)
        rid = torch.cumsum(new, dim=0) - 1
        rlen = torch.zeros(u_pad, dtype=torch.int64, device=dev).index_add_(
            0, rid, (order < k).to(torch.int64))
        length = rlen[rid]
        small_start = new & (length >= 2) & (length <= run_cap)
        hist.index_add_(0, (length - 1).clamp(0, d_cap + 1),
                        torch.where(small_start, length, 0))
        bigs.append(torch.where(new & (length > run_cap), length, 0).sum())
        runbits.append(pack_bits(new))
    return (torch.stack(orders) if orders else None, torch.stack(runbits),
            hist, torch.stack(bigs))


def _fused_labels(matches: torch.Tensor, orders: torch.Tensor | None,
                  extra_a: torch.Tensor, extra_b: torch.Tensor
                  ) -> torch.Tensor:
    """Program D (-x): min-label propagation over the resident match masks
    ([n_seg, d_max, u_pad] bool from program C: sorted positions (i, i+d)
    of partition p match) and the extra edges (the host's mid and big-run
    pairs, uploaded once), with two pointer jumps a sweep, to a fixed
    point.  Labels of the valid rows: the smallest index of each
    component, as :func:`humid_tpu_torch.cluster.connected_components_device`
    gives them over the whole pair list."""
    from ..cluster.labelprop import propagate

    n_seg, d_max, u_pad = matches.shape
    big = torch.iinfo(torch.int64).max

    def sweep(labels):
        for p in range(n_seg):
            order = None if p == 0 else orders[p - 1]
            for d in range(1, d_max + 1):
                lp = labels if order is None else labels[order]
                m = torch.where(matches[p, d - 1, :u_pad - d],
                                torch.minimum(lp[:-d], lp[d:]), big)
                mm = torch.full_like(lp, big)
                mm[:u_pad - d] = m
                mm[d:] = torch.minimum(mm[d:], m)
                mm = torch.minimum(lp, mm)
                labels = mm if order is None else labels.scatter(0, order, mm)
        m = torch.minimum(labels[extra_a], labels[extra_b])
        labels = labels.scatter_reduce(0, extra_a, m, "amin")
        labels = labels.scatter_reduce(0, extra_b, m, "amin")
        labels = labels[labels]
        return labels[labels]

    return propagate(sweep, torch.arange(u_pad, device=matches.device))


def _gather_idx(orders: torch.Tensor, part: torch.Tensor, pos: torch.Tensor):
    """Sparse order lookup: the unique index at sorted position ``pos`` of
    partition ``part`` (>= 1), so the host decodes match bitmaps without
    reading the order tables."""
    return orders[part - 1, pos]


def _gather_rows(table: torch.Tensor, orders: torch.Tensor,
                 part: torch.Tensor, pos: torch.Tensor):
    """Sparse row gather: (unique index, word lanes) at sorted position
    ``pos`` of partition ``part``: the mid-run members' words for the host
    enumeration, without reading the table."""
    idx = torch.where(part == 0, pos, orders[(part - 1).clamp(min=0), pos])
    return idx, table[idx]


class FusedPipeline:
    """Drives the fused programs and builds the host views the rest of the
    pipeline needs: ``unique()`` (the end of pass 1), ``tables()``,
    ``table()``, ``neighbors()``, ``device_labels()`` (-x)."""

    def __init__(self, feeder: DeviceFeeder, n_total: int,
                 filtered: np.ndarray, *, word_length: int, max_dist: int,
                 want_inverse: bool, want_labels: bool = False,
                 d_cap: int = 8, run_cap: int = 2048, tile: int = 2048,
                 shard: tuple[int, int] | None = None,
                 owned: np.ndarray | None = None,
                 impl: str | None = None, cap_total: int | None = None):
        self.feeder = feeder
        self.device = feeder.device
        self.w = feeder.w
        self.n_total = int(n_total)
        self.word_length = int(word_length)
        self.max_dist = int(max_dist)
        self.want_inverse = want_inverse
        self.want_labels = want_labels
        self.d_cap = d_cap
        self.run_cap = run_cap
        self.tile = tile
        # Host shard of the device runs engine: the part and, per
        # partition and table row, whether it owns the row's run.
        self.shard = shard
        self.owned = owned
        # The big-run and giant-run tile sweeps' implementation and first
        # capacity (:func:`.neighbors.sweep`).
        self.sweep_opts = dict(impl=impl, cap_total=cap_total)
        self.k = 0
        self.uniq: np.ndarray | None = None
        self._matches = None
        self._extra = None
        n_filtered = int(np.count_nonzero(filtered))
        self.n_usable = self.n_total - n_filtered
        # usable-row index -> read index (None: the identity).
        self._usable_to_read = (np.flatnonzero(~filtered) if n_filtered
                                else None)

    @classmethod
    def from_table(cls, packed: np.ndarray, *, word_length: int,
                   max_dist: int, device=None, **opts) -> "FusedPipeline":
        """The pipeline past program A, over ``packed`` [u, w] uint32, an
        ascending unique table on the host (the device runs engine): the
        table goes up once through a feeder, padded with all-ones rows, and
        ``neighbors()`` runs programs B and C on it.  ``opts`` may hold
        ``shard`` and ``owned`` ([n_seg, u] bool, the rows whose run the
        shard owns in each partition): then ``neighbors()`` returns the
        part's pairs."""
        u, w = packed.shape
        feeder = DeviceFeeder(w, u, device=device, chunk_rows=u)
        feeder.push(packed)
        fp = cls(feeder, u, np.zeros(u, bool), word_length=word_length,
                 max_dist=max_dist, want_inverse=False, **opts)
        fp._uniq, fp.k, fp.uniq = feeder.finish(), u, packed
        return fp

    # -- unique counting (program A) ----------------------------------
    def unique(self) -> int:
        """Program A on the resident reads; the host waits once, for k."""
        buf = self.feeder.finish()
        if self.feeder.n != self.n_usable:
            raise RuntimeError(f"the feeder holds {self.feeder.n} rows, "
                               f"{self.n_usable} usable reads were read")
        if self.n_usable == 0:
            z = torch.zeros(0, dtype=torch.int64, device=self.device)
            self._uniq, self._counts, self._first = buf, z, z
            self._inv = z if self.want_inverse else None
            return 0
        self._uniq, counts, first, self._inv, k = _unique_program(
            buf, self.n_usable, self.want_inverse)
        self.k = int(to_host(k)[0])
        self._counts, self._first = counts[:self.k], first[:self.k]
        return self.k

    def tables(self):
        """(counts [k] int64, first_occ [k] int64 read indices, inverse by
        read [n_total] int64 with -1 for filtered reads, or None): one
        bundled read-back."""
        got = to_host(self._counts, self._first,
                      *([self._inv] if self._inv is not None else []))
        counts, first = got[0], got[1]
        if self._usable_to_read is not None and len(first):
            first = self._usable_to_read[first]
        inv = None
        if self._inv is not None:
            inv = np.full(self.n_total, -1, np.int64)
            if self._usable_to_read is not None:
                inv[self._usable_to_read] = got[2]
            else:
                inv[:] = got[2]
        return counts, first, inv

    def table(self) -> np.ndarray:
        """Host copy of the unique table, read on first use (the sparse
        decode never needs it)."""
        if self.uniq is None:
            self.uniq = to_host(self._uniq[:self.k])[0].view(np.uint32)
        return self.uniq

    # -- neighbour pairs (programs B and C) ---------------------------
    def neighbors(self, info: dict | None = None):
        """All pairs within ``max_dist`` (a < b, sorted): equal to the host
        runs engine's.  ``info`` receives "metric", "strategy" ("fused"),
        "candidates", "d_max", "decode" ("sparse", "full", or "dense" for
        the giant-runs fallback) and "dense_fallbacks"."""
        from .neighbors import (_big_run_pairs, _combined_u64,
                                _dedupe_pairs, _empty_pairs,
                                enumerate_run_pairs, find_neighbor_pairs)

        info = {} if info is None else info
        info.update(metric="hamming", strategy="fused", candidates=0,
                    d_max=0, decode="sparse", dense_fallbacks=0)
        k = self.k
        if k <= 1 or self.max_dist == 0:
            return _empty_pairs()
        dev = self.device
        n_seg = self.max_dist + 1
        u_pad = _round_up(k, 32)
        table = self._uniq[:u_pad]
        seg_np = segment_lane_masks(self.word_length, n_seg, self.w)
        seg_masks = to_device(seg_np.view(np.int32), dev)
        orders, runbits_d, hist_d, big_d = _fused_partitions(
            table, k, seg_np, d_cap=self.d_cap, run_cap=self.run_cap)
        self._orders = orders
        owned_d = None
        if self.owned is not None:
            pad = np.zeros((n_seg, u_pad), bool)
            pad[:, :k] = self.owned
            owned_d = to_device(pad, dev)
        # The base sweeps (d <= 2) are wanted at every d_max: launched
        # before the histogram is read, so that wait rides behind them.
        d_base = min(2, self.d_cap)
        base_bm, base_mt = _runs_eval(table, orders, seg_masks, k,
                                      self.max_dist, d_hi=d_base,
                                      with_matches=self.want_labels,
                                      owned=owned_d)
        hist, big_rows, runbits = to_host(hist_d, big_d, runbits_d)
        if int(big_rows.sum()) > k:
            info.update(decode="dense", dense_fallbacks=1)
            return find_neighbor_pairs(self.table(), self.max_dist,
                                       word_length=self.word_length,
                                       tile=self.tile, strategy="dense",
                                       device=dev, shard=self.shard,
                                       **self.sweep_opts)
        # A power of two up to d_cap, grown until the runs longer than
        # d_max + 1 hold under 2% of the table; never below the base.
        d_max = 1
        while (d_max < self.d_cap
               and int(hist[d_max + 1:].sum()) > max(k // 50, 64)):
            d_max *= 2
        d_max = min(max(d_max, d_base), self.d_cap)
        bitmaps_d, matches = base_bm, base_mt
        if d_max > d_base:
            ext_bm, ext_mt = _runs_eval(table, orders, seg_masks, k,
                                        self.max_dist, d_lo=d_base + 1,
                                        d_hi=d_max,
                                        with_matches=self.want_labels,
                                        owned=owned_d)
            bitmaps_d = torch.cat([base_bm, ext_bm], dim=1)
            if self.want_labels:
                matches = torch.cat([base_mt, ext_mt], dim=1)
        self._matches = matches

        # Run structure on the host while the sweeps run.
        structs = []
        mid_total = 0
        cand_stat = 0
        any_big = False
        for p in range(n_seg):
            new = np.unpackbits(runbits[p], bitorder="little")[:k]
            run_start = np.flatnonzero(new)
            run_len = np.diff(np.append(run_start, k))
            structs.append((run_start, run_len))
            sl = run_len[(run_len >= 2) & (run_len <= self.run_cap)]
            cand_stat += int((sl * (sl - 1) // 2).sum())
            mid = (run_len > d_max + 1) & (run_len <= self.run_cap)
            mid_total += int(run_len[mid].sum())
            any_big |= bool((run_len > self.run_cap).any())
        info.update(candidates=cand_stat, d_max=d_max)

        bitmaps = to_host(bitmaps_d)[0]
        pos_pd = {}
        n_q_pairs = 0
        for p in range(n_seg):
            for d in range(1, d_max + 1):
                pos = _bitmap_positions(bitmaps[p, d - 1], k)
                if len(pos):
                    pos_pd[(p, d)] = pos
                    n_q_pairs += 2 * len(pos) if p else 0
        # Fetch only the rows the decode touches when that moves fewer
        # bytes than the order tables and the table; big runs need whole
        # permutations.
        sparse_bytes = n_q_pairs * 8 + mid_total * (8 + 4 * self.w)
        full_bytes = 8 * u_pad * (n_seg - 1) + 4 * self.w * u_pad
        use_sparse = not any_big and sparse_bytes < full_bytes
        info["decode"] = "sparse" if use_sparse else "full"
        parts_a: list[np.ndarray] = []
        parts_b: list[np.ndarray] = []
        extra_a: list[np.ndarray] = []
        extra_b: list[np.ndarray] = []
        if use_sparse:
            if mid_total:
                q_part, q_pos, lens = [], [], []
                for p in range(n_seg):
                    run_start, run_len = structs[p]
                    mid = (run_len > d_max + 1) & (run_len <= self.run_cap)
                    if mid.any():
                        ms, ml = run_start[mid], run_len[mid]
                        q_pos.append(np.repeat(ms, ml) + concat_aranges(ml))
                        q_part.append(np.full(int(ml.sum()), p, np.int64))
                        lens.append(ml)
                idx_d, words_d = _gather_rows(
                    table, orders, to_device(np.concatenate(q_part), dev),
                    to_device(np.concatenate(q_pos), dev))
                gidx, words = to_host(idx_d, words_d)
                words = words.view(np.uint32)
                lens = np.concatenate(lens)
                starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
                if self.owned is not None:
                    # A run's owner from its first member's row.
                    part = np.concatenate(q_part)[starts]
                    keep = self.owned[part, gidx[starts]]
                    starts, lens = starts[keep], lens[keep]
                ma, mb, _ = enumerate_run_pairs(
                    words, _combined_u64(words) if self.w <= 2 else None,
                    np.arange(len(words), dtype=np.int64), starts, lens,
                    self.max_dist)
                ma, mb = gidx[ma], gidx[mb]
                ma, mb = np.minimum(ma, mb), np.maximum(ma, mb)
                parts_a.append(ma)
                parts_b.append(mb)
                extra_a.append(ma)
                extra_b.append(mb)
            # Partition 0's order is the identity; the other partitions'
            # endpoints come from one sparse gather.
            q_part, q_pos, segs = [], [], []
            for (p, d), pos in pos_pd.items():
                if p == 0:
                    parts_a.append(pos)
                    parts_b.append(pos + d)
                else:
                    q_part.append(np.full(2 * len(pos), p, np.int64))
                    q_pos.append(np.concatenate([pos, pos + d]))
                    segs.append(len(pos))
            if q_pos:
                idx = to_host(_gather_idx(
                    orders, to_device(np.concatenate(q_part), dev),
                    to_device(np.concatenate(q_pos), dev)))[0]
                off = 0
                for m in segs:
                    ga, gb = idx[off:off + m], idx[off + m:off + 2 * m]
                    off += 2 * m
                    parts_a.append(np.minimum(ga, gb))
                    parts_b.append(np.maximum(ga, gb))
        else:
            uniq = self.table()
            orders_np = to_host(orders)[0]
            word64 = _combined_u64(uniq) if self.w <= 2 else None
            big_parts = []
            for p in range(n_seg):
                run_start, run_len = structs[p]
                order = (np.arange(k, dtype=np.int64) if p == 0
                         else orders_np[p - 1][:k])
                mid = (run_len > d_max + 1) & (run_len <= self.run_cap)
                big = run_len > self.run_cap
                if self.owned is not None:
                    own = self.owned[p][order[run_start]]
                    mid &= own
                    big &= own
                if mid.any():
                    ma, mb, _ = enumerate_run_pairs(
                        uniq, word64, order, run_start[mid], run_len[mid],
                        self.max_dist)
                    parts_a.append(ma)
                    parts_b.append(mb)
                    extra_a.append(ma)
                    extra_b.append(mb)
                if big.any():
                    big_parts.append((p, order, run_start[big],
                                      run_len[big]))
                for d in range(1, d_max + 1):
                    pos = pos_pd.get((p, d))
                    if pos is not None:
                        ga, gb = order[pos], order[pos + d]
                        parts_a.append(np.minimum(ga, gb))
                        parts_b.append(np.maximum(ga, gb))
            if big_parts:
                ba, bb = _big_run_pairs(uniq, big_parts, self.max_dist,
                                        tile=self.tile, device=dev,
                                        word_length=self.word_length,
                                        **self.sweep_opts)
                parts_a.append(ba)
                parts_b.append(bb)
                extra_a.append(ba)
                extra_b.append(bb)
        if self.want_labels:
            z = np.zeros(0, np.int64)
            self._extra = (np.concatenate(extra_a) if extra_a else z,
                           np.concatenate(extra_b) if extra_b else z)
        if not parts_a:
            return _empty_pairs()
        return _dedupe_pairs(np.concatenate(parts_a),
                             np.concatenate(parts_b))

    # -- -x component labels (program D) ------------------------------
    @property
    def has_matches(self) -> bool:
        return self._matches is not None

    def device_labels(self) -> np.ndarray:
        """Component labels (smallest unique index per component) of the
        valid rows, propagated on the device over the resident match masks
        and the uploaded mid and big-run edges; int64."""
        if self._matches is None:
            raise RuntimeError("device_labels needs neighbors() with "
                               "want_labels=True first")
        ea, eb = (to_device(x, self.device) for x in self._extra)
        labels = _fused_labels(self._matches, self._orders, ea, eb)
        return to_host(labels[:self.k])[0]


def fused_probe(packed_reads: np.ndarray, word_length: int,
                max_dist: int = 1, device=None):
    """One fused run over in-memory packed reads (nothing filtered), pushed
    in batches of 2^17 rows as pass 1 pushes them: the unit the router's
    calibration measures.  Returns (k, counts, first_occ, (a, b)); the
    table stays on the device unless a fallback needs it."""
    n, w = packed_reads.shape
    feeder = DeviceFeeder(w, n, device=device)
    for lo in range(0, n, 1 << 17):
        feeder.push(packed_reads[lo:lo + (1 << 17)])
    fp = FusedPipeline(feeder, n, np.zeros(n, bool), word_length=word_length,
                       max_dist=max_dist, want_inverse=False)
    fp.unique()
    pa, pb = fp.neighbors()
    counts, first, _ = fp.tables()
    return fp.k, counts, first, (pa, pb)
