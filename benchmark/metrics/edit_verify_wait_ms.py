"""edit_verify_wait_ms: the host blocked on the card after the DP
verify's last launch (``ops/edit._wait``), in ms an iteration: the
program's span "Calculating neighbours using Levenshtein
distance/wait verify", averaged over the window's iterations.  None
where the program has no such span."""


def read(ctx):
    return ctx.phase_ms(
        ("Calculating neighbours using Levenshtein distance/wait verify",))
