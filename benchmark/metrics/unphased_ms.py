"""unphased_ms: the time of ``humid_tpu_torch.run`` that none of its
direct children names, in ms an iteration: the program's root span
``run`` less the sum of the phases and the spans directly below it
(every name without a "/", but "unique counting (overlapped)", which
lies inside "Reading data"; the tree is in ``phaselog.py``), averaged
over the window's iterations.  None where the program has no span
``run``."""

ROOT = "run"
NESTED = {"unique counting (overlapped)"}


def read(ctx):
    left = [t[ROOT] - sum(v for k, v in t.items()
                          if "/" not in k and k != ROOT and k not in NESTED)
            for t in ctx.timings if ROOT in t]
    return 1e3 * sum(left) / len(left) if left else None
