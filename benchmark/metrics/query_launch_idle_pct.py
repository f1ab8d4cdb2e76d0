"""``query_launch_idle_pct.<cell kind>``: the share of the traced window in
which the card is idle while the host of UltraQuery's evaluation call
(``harness/query_spans.py``) enqueues a projection pass
(``ultra.query.project``) or the relation precompute
(``ultra.query.precompute``): the card waiting for the host to launch the
models' work. Nothing without that call's span."""

from benchmark.harness import query_spans


def read(ctx):
    return query_spans.idle_pct(ctx.trace, ("ultra.query.project", "ultra.query.precompute"))
