"""``copy_idle_pct.<cell kind>``: the share of the traced window in which
the card is idle while the host uploads a batch and its masks
(``ultra.eval.upload``) or waits for and copies back the ranks
(``ultra.eval.download``). Nothing without the program's spans."""

from benchmark.harness.spans import idle_pct


def read(ctx):
    return idle_pct(ctx.trace, ("ultra.eval.upload", "ultra.eval.download"))
