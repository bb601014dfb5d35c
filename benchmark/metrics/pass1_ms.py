"""pass1_ms: pass 1, reading the FastQ files and packing their words
(``io/``, ``words.py``), in ms an iteration: the program's phase timer
"Reading data", averaged over the window's iterations."""


def read(ctx):
    return ctx.phase_ms(("Reading data",))
