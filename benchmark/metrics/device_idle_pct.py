"""``device_idle_pct.<cell kind>``: the share of the traced window in which
no operation runs on the card (``harness/trace.py``: the union of the
operations' intervals). Nothing when the trace holds no device operation."""


def read(ctx):
    if not ctx.trace.device_ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
