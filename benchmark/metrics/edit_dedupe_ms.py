"""edit_dedupe_ms: the shifted-segment search's dedupe of its candidate
pairs (``ops/neighbors._dedupe_pairs``), in ms an iteration: the
program's span "Calculating neighbours using Levenshtein
distance/dedupe" (the joins' outputs concatenated, sorted and
deduplicated on the host), averaged over the window's iterations.  None
where the program has no such span."""


def read(ctx):
    return ctx.phase_ms(
        ("Calculating neighbours using Levenshtein distance/dedupe",))
