"""``cheap_idle_pct.<cell kind>``: the share of the traced window in which
the card is idle while the host runs the grouped executor's cheap-op slots
(``ultra.query.cheap``: the stack's pushes, pops and fuzzy-logic operations
of a round, small operations launched one at a time), inside UltraQuery's
evaluation call (``harness/query_spans.py``). Nothing without that call's
span."""

from benchmark.harness import query_spans


def read(ctx):
    return query_spans.idle_pct(ctx.trace, ("ultra.query.cheap",))
