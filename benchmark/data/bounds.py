"""The card's published peaks and the least time of an rspmm launch.

A frozen copy of the port's bound arithmetic (``ultra_tpu_torch/utils/
benchlib.py``: ``H100_BYTES_PER_S``, ``H100_F32_FLOPS``, ``bound_ms``,
``rspmm_bound_ms``), taken from shapes alone: a launch's operands are
known from its output shape and the graph it walks, so no tensor is read.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: HBM3 bandwidth and
# f32 outside the tensor cores (the arithmetic of the rspmm and of a model
# whose configuration states f32 with TF32 off)
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

ROW_BYTES = {"f32": 4, "bf16": 2}


def bound_ms(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the larger of the bytes over the card's
    memory rate and the f32 operations over its f32 rate."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rspmm_bound_ms(rows: int, in_rows: int, types: int, edges: int, live: int, feat: int,
                   rel_type: str = "f32", x_type: str = "f32"):
    """Least time of one sum or min/max rspmm forward over a CSR of ``rows``
    output rows and ``edges`` edges (``live`` of weight other than 0): x
    (``in_rows`` x F) and the relation rows (``types`` x F) read once at
    their element size, the CSR (row pointers, and source, type, edge id and
    weight of each edge) read once, the f32 output written once, and 3 f32
    operations per feature of each live edge."""
    nbytes = (in_rows * ROW_BYTES[x_type] + types * ROW_BYTES[rel_type]) * feat
    nbytes += 4 * rows * feat + 8 * (rows + 1) + 16 * edges
    return bound_ms(nbytes, 3 * live * feat)
