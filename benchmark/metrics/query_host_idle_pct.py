"""``query_host_idle_pct.<cell kind>``: the share of the traced window in
which the card is idle while the host of UltraQuery's evaluation call
(``harness/query_spans.py``) prepares a batch (``ultra.query.schedule``:
the programs, the schedules, the answer lists and their uploads), enqueues
its ranking (``ultra.query.metrics``) or waits for the per-query vectors
(``ultra.query.download``). Nothing without that call's span."""

from benchmark.harness import query_spans


def read(ctx):
    return query_spans.idle_pct(ctx.trace, ("ultra.query.schedule", "ultra.query.metrics",
                                            "ultra.query.download"))
