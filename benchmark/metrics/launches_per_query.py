"""``launches_per_query.<cell kind>``: every kernel the trace shows on the
card in the window, the program's and PyTorch's (copies and memsets left
out), over the queries answered in it. Nothing without a kernel."""


def read(ctx):
    kernels = len(ctx.trace.kernels)
    if not kernels or not ctx.work["queries"]:
        return None
    return kernels / ctx.work["queries"]
