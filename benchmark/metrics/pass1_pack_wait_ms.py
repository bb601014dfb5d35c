"""pass1_pack_wait_ms: pass 1's main thread blocked on a packing job
(``pipeline._pass1``), in ms an iteration: the program's span "Reading
data/wait pack", summed over the batches, averaged over the window's
iterations.  None where the program has no such span."""


def read(ctx):
    return ctx.phase_ms(("Reading data/wait pack",))
