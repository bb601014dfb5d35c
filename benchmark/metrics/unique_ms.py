"""unique_ms: unique counting (``ops/unique.py``), in ms an iteration:
the program's phase timer "unique counting" (or its fused or overlapped
form), averaged over the window's iterations."""


def read(ctx):
    return ctx.phase_ms(("unique counting", "unique counting (fused)",
                         "unique counting (overlapped)"))
