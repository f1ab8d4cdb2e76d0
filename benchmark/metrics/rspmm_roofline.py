"""``rspmm_roofline.<cell kind>``: the rspmm forwards' share of their
roofline, sum of least times over sum of device times.

The launches are the program's counters over the window (``rspmm_sum_fwd``,
B1, and ``rspmm_minmax_fwd``, B3, by output shape ``(rows, F)`` and a bf16
instance's row types); a launch's least time is ``data/bounds.py::
rspmm_bound_ms`` of the graph whose row count it has. The device time is
that of the kernels of the piece walk (``pieces::piece_kernel``, and the
second pass of a long row, ``long_row_kernel`` or ``split_row_kernel``,
counted with its launch). A window that also ran a gradient walk (B1 on
the transposed CSR, B2, B4, B5, B6), whose kernels share those names, or
whose launches fit no graph, gets no reading.
"""

from benchmark.data.bounds import rspmm_bound_ms

FORWARDS = ("rspmm_sum_fwd", "rspmm_minmax_fwd")
KERNELS = ("piece_kernel", "long_row_kernel", "split_row_kernel")


def read(ctx):
    if any(n for name, counts in ctx.launches.items() if name not in FORWARDS
           for n in counts.values()):
        return None
    by_rows = {g["nodes"]: g for g in ctx.graphs.values()}
    least_ms = 0.0
    for name in FORWARDS:
        for key, n in ctx.launches.get(name, {}).items():
            rows, feat = key[0], key[1]
            types = key[2].split("_") if len(key) > 2 else ("f32", "f32")
            g = by_rows.get(rows)
            if g is None:
                return None
            least_ms += n * rspmm_bound_ms(rows, rows, g["relations"], g["edges"], g["edges"],
                                           feat, rel_type=types[0], x_type=types[1])[0]
    device_s = sum(end - start for name, start, end in ctx.trace.kernels
                   if any(k in name for k in KERNELS))
    if not least_ms or not device_s:
        return None
    return 100.0 * least_ms * 1e-3 / device_s
