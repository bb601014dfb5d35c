"""Phase-timer logging, drop-in compatible with the reference's log format
(log.cc:4-15): ``<msg>... done. (XmYs)`` written to the ``-l`` file
(default /dev/stderr), and the spans that divide a run further.

Beyond the reference, every phase is also:

* recorded with sub-second resolution (``time.perf_counter``) in
  :attr:`PhaseLog.timings`, and
* bracketed in a ``torch.profiler.record_function`` range, so a
  ``torch.profiler`` trace taken around a run (``run(profile_dir=...)``
  or $HUMID_TPU_TORCH_PROFILE writes one) attributes device kernels to
  pipeline phases.

A span (:meth:`PhaseLog.span`) is timed and bracketed the same way but
writes no line to the log, so the log keeps the reference's lines.
Spans are opened on the main thread only, so each (but the root
``run``) is a range of the trace on the profiler's clock.
:meth:`PhaseLog.totals` (surfaced as ``PipelineResult.extra["timings"]``)
gives the phases and the spans by name, in seconds, a name opened more
than once summed.

The tree of one ``pipeline.run`` (a route that skips a step has no span
for it):

* ``run`` (span): the root, from the log's opening (the device is
  resolved just before it) to the return.  It is timed but opens no
  profiler range: a reader that names a trace's idle gap by the range
  covering most of it, the first listed on a tie, would give every gap
  to a root listed before its children.  Its direct children:

  - the phases (log lines): "Determing nucleotides to take", "Reading
    data", "Calculating neighbours using Hamming distance" (or "...
    Levenshtein distance"), "Calculating directional clusters" (or
    "Calculating maximum clusters"), "Writing filtered results",
    "Writing annotated results", "Calculating count and neighbour
    stats" (it holds the statistics writer);
  - the spans ``set-up`` (the allocator, the record caches and the
    route decision; opened twice, around the first phase), ``unique
    counting`` or ``unique counting (fused)``, and ``outputs`` (the
    output directory, the representatives, the per-read cluster ids).
    ``unique counting (overlapped)`` lies inside "Reading data" instead:
    on that route pass 1 does the counting.

* Children of "Reading data": ``Reading data/wait reader`` (the main
  thread blocked on the reader's queue), ``Reading data/wait pack``
  (blocked on a packing job) and ``Reading data/concat`` (the final
  concatenations).
* Children of the neighbour phase ``<phase>``: ``<phase>/inputs`` (the
  dense sweep's rows and tile list), ``<phase>/upload`` (its tensors to
  the device), ``<phase>/wait K1`` (the host's wait for each launch of
  kernel K1; on the CPU, the plain version that stands in for it),
  ``<phase>/pairs`` (the sort and the copies back) and ``<phase>/csr``
  (the pair list to CSR).  The shifted edit search (-e, "Calculating
  neighbours using Levenshtein distance") opens ``<phase>/joins`` (the
  segment keys, their sorts and the merge joins), ``<phase>/dedupe``
  (the first-join union of the candidates, with no sort),
  ``<phase>/verify`` (the DP's batches: pinning, index copies, gathers,
  launches) and ``<phase>/wait verify`` (the host blocked on the device)
  before ``<phase>/csr``.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext

import torch


def no_span(name: str):
    """The span callable of a caller given none: times nothing."""
    return nullcontext()


class PhaseLog:
    def __init__(self, path: str = "/dev/stderr"):
        parent = os.path.dirname(path)
        if parent and not os.path.isdir(parent) and not path.startswith("/dev/"):
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w")
        #: (phase, seconds) of each phase, in order.
        self.timings: list[tuple[str, float]] = []
        #: (span, seconds) of each span, in the order they closed.
        self.span_timings: list[tuple[str, float]] = []
        self._current: str | None = None
        self._range = None

    def start(self, message: str) -> float:
        self._f.write(f"{message}... ")
        self._f.flush()
        self._current = message
        # The range's own cost is timed with the phase, so that a parent's
        # children tile it.
        t = time.perf_counter()
        self._range = torch.profiler.record_function(message)
        self._range.__enter__()
        return t

    def end(self, start: float) -> None:
        self._close_range()
        dt = time.perf_counter() - start
        seconds = int(dt)
        self._close_phase(dt, f"done. ({seconds // 60}m{seconds % 60}s)")

    def fail(self, start: float) -> None:
        """Close a phase that raised: the log line says "failed.", and the
        profiler range is closed (left open, it would claim every later
        kernel for the dead phase)."""
        self._close_range()
        self._close_phase(time.perf_counter() - start, "failed.")

    def _close_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def _close_phase(self, dt: float, verdict: str) -> None:
        self._f.write(f"{verdict}\n")
        self._f.flush()
        if self._current is not None:
            self.timings.append((self._current, dt))
            self._current = None

    @contextmanager
    def phase(self, message: str):
        """``with log.phase(message):`` — :meth:`start`, then :meth:`end`,
        or :meth:`fail` if the body raises (the exception goes on)."""
        t = self.start(message)
        try:
            yield
        except BaseException:
            self.fail(t)
            raise
        self.end(t)

    @contextmanager
    def span(self, name: str, *, in_trace: bool = True):
        """``with log.span(name):`` — time the body into
        :attr:`span_timings` and bracket it in a profiler range (none
        with ``in_trace=False``); no log line.  The span closes when the
        body raises, too."""
        t = time.perf_counter()
        try:
            with (torch.profiler.record_function(name) if in_trace
                  else nullcontext()):
                yield
        finally:
            self.span_timings.append((name, time.perf_counter() - t))

    def spans_under(self, parent: str):
        """A span callable for code below ``parent``: ``name`` opens the
        span ``"<parent>/<name>"``."""
        return lambda name: self.span(f"{parent}/{name}")

    def totals(self) -> dict[str, float]:
        """Seconds by phase and span name, a repeated name summed."""
        out: dict[str, float] = {}
        for name, dt in self.timings + self.span_timings:
            out[name] = out.get(name, 0.0) + dt
        return out

    def write(self, text: str) -> None:
        self._f.write(text)
        self._f.flush()

    def close(self) -> None:
        self._f.close()
