"""edit_joins_ms: the shifted-segment search's host joins
(``ops/neighbors.shifted_joins``, ``_merge_join``), in ms an iteration:
the program's span "Calculating neighbours using Levenshtein
distance/joins" (segment keys, their sorts and the merge joins),
averaged over the window's iterations.  None where the program has no
such span."""


def read(ctx):
    return ctx.phase_ms(
        ("Calculating neighbours using Levenshtein distance/joins",))
