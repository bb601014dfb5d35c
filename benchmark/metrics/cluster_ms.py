"""cluster_ms: directional clustering (``cluster/``,
``pipeline.cluster_dispatch``), in ms an iteration: the program's phase
timer "Calculating directional clusters", averaged over the window's
iterations."""


def read(ctx):
    return ctx.phase_ms(("Calculating directional clusters",))
