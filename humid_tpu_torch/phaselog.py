"""Phase-timer logging, drop-in compatible with the reference's log format
(log.cc:4-15): ``<msg>... done. (XmYs)`` written to the ``-l`` file
(default /dev/stderr).

Beyond the reference, every phase is also:

* recorded with sub-second resolution in :attr:`PhaseLog.timings`
  (surfaced as ``PipelineResult.extra["timings"]``), and
* bracketed in a ``torch.profiler.record_function`` range, so a
  ``torch.profiler`` trace taken around a run (``run(profile_dir=...)``
  or $HUMID_TPU_TORCH_PROFILE writes one) attributes device kernels to
  pipeline phases.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


class PhaseLog:
    def __init__(self, path: str = "/dev/stderr"):
        parent = os.path.dirname(path)
        if parent and not os.path.isdir(parent) and not path.startswith("/dev/"):
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w")
        self.timings: list[tuple[str, float]] = []
        self._current: str | None = None
        self._range = None

    def start(self, message: str) -> float:
        self._f.write(f"{message}... ")
        self._f.flush()
        self._current = message
        self._range = torch.profiler.record_function(message)
        self._range.__enter__()
        return time.time()

    def end(self, start: float) -> None:
        dt = time.time() - start
        seconds = int(dt)
        self._close_phase(dt, f"done. ({seconds // 60}m{seconds % 60}s)")

    def fail(self, start: float) -> None:
        """Close a phase that raised: the log line says "failed.", and the
        profiler range is closed (left open, it would claim every later
        kernel for the dead phase)."""
        self._close_phase(time.time() - start, "failed.")

    def _close_phase(self, dt: float, verdict: str) -> None:
        self._f.write(f"{verdict}\n")
        self._f.flush()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
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

    def write(self, text: str) -> None:
        self._f.write(text)
        self._f.flush()

    def close(self) -> None:
        self._f.close()
