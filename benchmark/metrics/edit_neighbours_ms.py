"""edit_neighbours_ms: the Levenshtein neighbour search (-e;
``ops/neighbors.find_edit_pairs_shifted``, ``ops/edit.py``), in ms an
iteration: the program's phase timer "Calculating neighbours using
Levenshtein distance", averaged over the window's iterations.  None where
no iteration has the phase."""


def read(ctx):
    return ctx.phase_ms(("Calculating neighbours using Levenshtein distance",))
