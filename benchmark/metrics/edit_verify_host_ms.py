"""edit_verify_host_ms: the host's side of the DP verify
(``ops/edit.edit_pairs_verify``), in ms an iteration: the program's span
"Calculating neighbours using Levenshtein distance/verify" (the
candidates pinned, and every batch's index copies, gathers and DP
launches, up to the one wait), averaged over the window's iterations.
None where the program has no such span."""


def read(ctx):
    return ctx.phase_ms(
        ("Calculating neighbours using Levenshtein distance/verify",))
