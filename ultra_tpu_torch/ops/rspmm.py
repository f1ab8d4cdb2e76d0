"""Generalized relational sparse matrix multiply (rspmm) and its gradient.

Counterpart of ``ultra_tpu/ops/rspmm.py``. Semantics:

    out[row, f] = sum_{e : dst[e] == row} w[e] * op(rel[type[e], f], x[src[e], f])

with ``op`` = ``*`` (``mul="mul"``, distmult) or ``+`` (``mul="add"``,
transe). Output rows are ``edge_index[0]``, inputs are gathered from
``edge_index[1]``; an edge of weight 0 contributes nothing. Operands keep
the node-major ``(V, B, D)`` layout and reach the kernel flattened to
``(V, B*D)`` rows.

``sum="min"`` and ``"max"`` take the minimum or the maximum over the live
edges of ``w[e] * op(rel, x)`` instead (an edge of weight 0 is left out,
not counted as 0), and a row with no live edge is +inf (min) or -inf (max).
Their gradient goes to every live edge whose message equals the output,
the whole of it to each tying edge (``ultra_tpu/ops/rspmm.py:206-222``).

Each aggregator is a ``torch.autograd.Function``. Sum: the forward is
kernel B1 on the destination-major CSR, the input gradient B1 on the
source-major CSR and the relation gradient kernel B2 on the type segments
(``ops/rspmm_cuda.py``). Min/max: the forward is kernel B3, the input
gradient B4 and the relation gradient B5 on the same three layouts
(``ops/rspmm_minmax_cuda.py``); the backward routes against the forward's
own saved output. The edge-weight gradient of both is kernel B6 on the
destination-major CSR (``ops/rspmm_cuda.py::rspmm_dw``): for sum an edge
masked to weight 0 at run time gets its true derivative, for min/max 0 (the
route asks for a live edge), and a slot left out of the CSR when the graph
was built (weight 0 then: the padding) gets 0, as the Pallas backend gives
(``rspmm_pallas.py:561-567``; the XLA backend gives padding its derivative).
"""

from __future__ import annotations

import torch

from ultra_tpu_torch.graph import Graph, build_layouts
from ultra_tpu_torch.ops.rspmm_cuda import (
    rspmm_dw, rspmm_sum_drel, rspmm_sum_dx, rspmm_sum_fwd,
)
from ultra_tpu_torch.ops.rspmm_minmax_cuda import (
    rspmm_minmax_drel, rspmm_minmax_dx, rspmm_minmax_fwd,
)

_SUM_OPS = ("add", "min", "max")


class _SumRspmm(torch.autograd.Function):
    """Sum rspmm over (R, F) relation and (N, F) x rows; ``layouts`` is
    (csr, csr_src, segments). The backward computes each gradient only when
    autograd asks for it."""

    @staticmethod
    def forward(ctx, layouts, edge_weight, relation, x, mul: str):
        ctx.layouts, ctx.mul = layouts, mul
        ctx.save_for_backward(edge_weight, relation, x)
        return rspmm_sum_fwd(layouts[0], edge_weight, relation, x, mul)

    @staticmethod
    def backward(ctx, g):
        edge_weight, relation, x = ctx.saved_tensors
        (csr, csr_src, segments), mul = ctx.layouts, ctx.mul
        g = g.contiguous()
        d_w = d_rel = d_x = None
        if ctx.needs_input_grad[1]:
            d_w = rspmm_dw(csr, edge_weight, relation, x, g, mul)
        if ctx.needs_input_grad[2]:
            d_rel = rspmm_sum_drel(segments, edge_weight, x if mul == "mul" else g, g, mul)
        if ctx.needs_input_grad[3]:
            d_x = rspmm_sum_dx(csr_src, edge_weight, relation, g, mul)
        return None, d_w, d_rel, d_x, None


class _MinMaxRspmm(torch.autograd.Function):
    """Min/max rspmm over (R, F) relation and (N, F) x rows. The forward's
    output is saved: the backward routes the gradient to the edges whose
    recomputed message equals it, and computes each gradient only when
    autograd asks for it."""

    @staticmethod
    def forward(ctx, layouts, edge_weight, relation, x, mul: str, is_min: bool):
        ctx.layouts, ctx.mul = layouts, mul
        out = rspmm_minmax_fwd(layouts[0], edge_weight, relation, x, mul, is_min)
        ctx.save_for_backward(edge_weight, relation, x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        edge_weight, relation, x, out = ctx.saved_tensors
        (csr, csr_src, segments), mul = ctx.layouts, ctx.mul
        g = g.contiguous()
        d_w = d_rel = d_x = None
        if ctx.needs_input_grad[1]:
            d_w = rspmm_dw(csr, edge_weight, relation, x, g, mul, out=out)
        if ctx.needs_input_grad[2]:
            d_rel = rspmm_minmax_drel(segments, edge_weight, relation, x, g, out, mul)
        if ctx.needs_input_grad[3]:
            d_x = rspmm_minmax_dx(csr_src, edge_weight, relation, x, g, out, mul)
        return None, d_w, d_rel, d_x, None, None


def _rspmm(layouts, edge_weight, relation, x, sum: str, mul: str):
    if sum not in _SUM_OPS:
        raise ValueError(f"sum must be one of {_SUM_OPS}, got {sum!r}")
    feat = tuple(x.shape[1:])
    # the relation operand may broadcast over the batch (e.g. a (R, 1, D)
    # view); the kernel takes it materialised as contiguous (R, B*D) rows.
    # The Function sees the materialised rows, so autograd sums their
    # gradient back over the broadcast axis.
    relation = relation.expand((relation.shape[0],) + feat)
    rows = (relation.reshape(relation.shape[0], -1).contiguous(),
            x.reshape(x.shape[0], -1).contiguous())
    if sum == "add":
        out = _SumRspmm.apply(layouts, edge_weight, *rows, mul)
    else:
        out = _MinMaxRspmm.apply(layouts, edge_weight, *rows, mul, sum == "min")
    return out.reshape((out.shape[0],) + feat)


def generalized_rspmm(
    edge_index, edge_type, edge_weight, relation, x, *,
    sum: str = "add", mul: str = "mul", num_nodes: int | None = None,
):
    """rspmm over raw edge arrays: (num_nodes, ...feat).

    ``edge_index`` (2, E) with row 0 = dst, row 1 = src; ``edge_type`` (E,);
    ``edge_weight`` (E,) f32, 0 = absent; ``relation`` (R, ...feat) and
    ``x`` (V, ...feat). Builds the edge layouts on every call: a caller with
    a fixed graph uses :func:`rspmm_from_graph`, whose layouts are built
    once.
    """
    if num_nodes is None:
        num_nodes = x.shape[0]
    layouts = build_layouts(edge_index, edge_type, int(num_nodes), int(relation.shape[0]))
    return _rspmm(layouts, edge_weight, relation, x, sum, mul)


def rspmm_from_graph(graph: Graph, relation, x, *, sum: str = "add", mul: str = "mul"):
    """rspmm over ``graph``'s edge layouts under its current edge weights."""
    layouts = (graph.csr, graph.csr_src, graph.segments)
    return _rspmm(layouts, graph.edge_weight, relation, x, sum, mul)


def degree(graph: Graph, *, include_self_loop: bool = True):
    """Live in-degree per output row (+1 for the implicit boundary
    self-loop, as the reference's ``degree(index) + 1``)."""
    deg = torch.zeros(graph.num_nodes, dtype=torch.float32, device=graph.device)
    deg.index_add_(0, graph.edge_index[0], (graph.edge_weight != 0.0).float())
    return deg + 1.0 if include_self_loop else deg


def spmm_max(edge_index, value, m: int, n: int, matrix):
    """Sparse-dense product with max aggregation, as torch_sparse's:
    ``out[row] = max_e value[e] * matrix[col_e]`` over the edges
    ``(row, col) = edge_index``, -inf for a row with no edge; a 1-D
    ``matrix`` is taken as (n, 1). Every edge counts, a 0 value as a
    message of 0 (so not through B3, which reads weight 0 as no edge)."""
    row, col = edge_index[0], edge_index[1]
    matrix = matrix if matrix.ndim > 1 else matrix[:, None]
    msg = matrix[col] * value[:, None]
    out = torch.full((m, msg.shape[1]), float("-inf"), dtype=msg.dtype, device=msg.device)
    return out.scatter_reduce_(0, row[:, None].expand_as(msg), msg, "amax", include_self=True)
