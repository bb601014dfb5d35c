"""neighbours_host_ms: the neighbour search's host work around kernel K1
(``ops/neighbors.py``, ``ops/cuda_hamming.py``), in ms an iteration: the
program's phase "Calculating neighbours using Hamming distance" less its
spans "wait K1" (the host waiting for K1's launches) and "pairs" (the
sort and the copies back), averaged over the iterations that waited for
K1.  None where no iteration has the span "wait K1"."""

PHASE = "Calculating neighbours using Hamming distance"
WAITS = (f"{PHASE}/wait K1", f"{PHASE}/pairs")


def read(ctx):
    host = [t[PHASE] - sum(t.get(n, 0.0) for n in WAITS)
            for t in ctx.timings if PHASE in t and WAITS[0] in t]
    return 1e3 * sum(host) / len(host) if host else None
