"""``host_idle_pct.<cell kind>``: the share of the traced window in which
the card is idle while the host builds the strict-negative masks
(``ultra.eval.mask``) or counts each mask row's candidates
(``ultra.eval.negatives``). Nothing without the program's spans."""

from benchmark.harness.spans import idle_pct


def read(ctx):
    return idle_pct(ctx.trace, ("ultra.eval.mask", "ultra.eval.negatives"))
