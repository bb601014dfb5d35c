"""stats_phase_ms: the statistics writer (``stats.py``), in ms an
iteration: the program's phase "Calculating count and neighbour stats",
which holds the writer where the program keeps a span tree (its root
span ``run`` is in the timings), averaged over the window's iterations.
None where the program has no span tree: there the phase closes before
the writer runs."""

PHASE = "Calculating count and neighbour stats"


def read(ctx):
    if not any("run" in t for t in ctx.timings):
        return None
    return ctx.phase_ms((PHASE,))
