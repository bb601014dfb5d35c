"""device_idle_pct: the share of the profiled slice (whole iterations
after the window) in which no operation ran on the card, in %: device
operations' intervals merged, from the profiler's trace."""


def read(ctx):
    if not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
