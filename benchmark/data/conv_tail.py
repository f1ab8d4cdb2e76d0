"""The least time of the conv's tail, E2, over a number of rows.

A frozen copy of the port's arithmetic for E2 (``chip_smoke.py::
conv_tail_rows``, over ``ultra_tpu_torch/utils/benchlib.py::bound_ms``): a
launch over ``rows`` rows of width 64 reads x and u and writes the output
once, 12 bytes an element (both instances take x in f32), and computes the
linear of ``[x | u]``, 2 x 128 x 64 f32 operations a row; the layer norm,
ReLU and short cut are not counted. Both terms are linear in the rows, so
the bound of several launches is the bound of their summed rows.
"""

from __future__ import annotations

from benchmark.data.bounds import bound_ms

WIDTH = 64  # the layer's width in and out


def conv_tail_bound_ms(rows: int) -> float:
    """The larger of the bytes' time and the operations' time, in ms."""
    return bound_ms(12 * rows * WIDTH, 2 * (2 * WIDTH) * WIDTH * rows)[0]
