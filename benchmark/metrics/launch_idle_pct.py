"""``launch_idle_pct.<cell kind>``: the share of the traced window in which
the card is idle while the host enqueues a batch's pass and ranking
(``ultra.eval.score``) or the relation precompute
(``ultra.eval.precompute``): the card waiting for the host to launch.
Nothing without the program's spans."""

from benchmark.harness.spans import idle_pct


def read(ctx):
    return idle_pct(ctx.trace, ("ultra.eval.score", "ultra.eval.precompute"))
