"""pass1_reader_wait_ms: pass 1's main thread blocked on the reader's
queue (``io/reader.read_tuples``), in ms an iteration: the program's span
"Reading data/wait reader", summed over the batches, averaged over the
window's iterations.  None where the program has no such span."""


def read(ctx):
    return ctx.phase_ms(("Reading data/wait reader",))
