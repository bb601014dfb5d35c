"""neighbours_ms: the neighbour search (``ops/neighbors.py``,
``ops/runs_device.py``, ``ops/cuda_hamming.py``), in ms an iteration: the
program's phase timer "Calculating neighbours using Hamming distance",
averaged over the window's iterations."""


def read(ctx):
    return ctx.phase_ms(("Calculating neighbours using Hamming distance",))
