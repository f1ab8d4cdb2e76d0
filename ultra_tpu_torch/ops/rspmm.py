"""Generalized relational sparse matrix multiply (rspmm), forward only.

Counterpart of ``ultra_tpu/ops/rspmm.py``. Semantics:

    out[row, f] = sum_{e : dst[e] == row} w[e] * op(rel[type[e], f], x[src[e], f])

with ``op`` = ``*`` (``mul="mul"``, distmult) or ``+`` (``mul="add"``,
transe). Output rows are ``edge_index[0]``, inputs are gathered from
``edge_index[1]``; an edge of weight 0 contributes nothing. Operands keep
the node-major ``(V, B, D)`` layout and reach the kernel flattened to
``(V, B*D)`` rows.

Only ``sum="add"`` is ported. The min/max aggregators and every backward
are later slices of the port (ROADMAP A8 with B3-B5, A7 with B1 d_x and B2).
"""

from __future__ import annotations

import torch

from ultra_tpu_torch.graph import CSR, Graph, build_csr
from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_fwd

_SUM_OPS = ("add", "min", "max")


def _rspmm(csr: CSR, edge_weight, relation, x, sum: str, mul: str):
    if sum not in _SUM_OPS:
        raise ValueError(f"sum must be one of {_SUM_OPS}, got {sum!r}")
    if sum != "add":
        raise NotImplementedError(
            f"sum={sum!r} rspmm is not ported yet (ROADMAP A8 / B3: min/max forward)"
        )
    if torch.is_grad_enabled() and (relation.requires_grad or x.requires_grad):
        raise NotImplementedError(
            "the rspmm backward is not ported yet (ROADMAP A7: B1 d_x and B2); "
            "run inference under torch.no_grad()"
        )
    feat = tuple(x.shape[1:])
    # the relation operand may broadcast over the batch (e.g. a (R, 1, D)
    # view); the kernel takes it materialised as contiguous (R, B*D) rows
    relation = relation.expand((relation.shape[0],) + feat)
    out = rspmm_sum_fwd(
        csr,
        edge_weight,
        relation.reshape(relation.shape[0], -1).contiguous(),
        x.reshape(x.shape[0], -1).contiguous(),
        mul,
    )
    return out.reshape((out.shape[0],) + feat)


def generalized_rspmm(
    edge_index, edge_type, edge_weight, relation, x, *,
    sum: str = "add", mul: str = "mul", num_nodes: int | None = None,
):
    """rspmm over raw edge arrays: (num_nodes, ...feat).

    ``edge_index`` (2, E) with row 0 = dst, row 1 = src; ``edge_type`` (E,);
    ``edge_weight`` (E,) f32, 0 = absent; ``relation`` (R, ...feat) and
    ``x`` (V, ...feat). Builds a CSR on every call: a caller with a fixed
    graph uses :func:`rspmm_from_graph`, whose CSR is built once.
    """
    if num_nodes is None:
        num_nodes = x.shape[0]
    csr = build_csr(edge_index, edge_type, int(num_nodes))
    return _rspmm(csr, edge_weight, relation, x, sum, mul)


def rspmm_from_graph(graph: Graph, relation, x, *, sum: str = "add", mul: str = "mul"):
    """rspmm over ``graph``'s CSR under its current edge weights."""
    return _rspmm(graph.csr, graph.edge_weight, relation, x, sum, mul)


def degree(graph: Graph, *, include_self_loop: bool = True):
    """Live in-degree per output row (+1 for the implicit boundary
    self-loop, as the reference's ``degree(index) + 1``)."""
    deg = torch.zeros(graph.num_nodes, dtype=torch.float32, device=graph.device)
    deg.index_add_(0, graph.edge_index[0], (graph.edge_weight != 0.0).float())
    return deg + 1.0 if include_self_loop else deg
