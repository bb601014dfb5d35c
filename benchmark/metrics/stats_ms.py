"""stats_ms: the statistics writer (``stats.py``), in ms an iteration.

The program's phase "Calculating count and neighbour stats" closes before
its histograms are computed and written, so the harness times the call
of ``write_statistics`` itself in the traced run's window."""


def read(ctx):
    return ctx.span_ms("write_statistics")
