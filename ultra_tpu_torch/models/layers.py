"""Generalized relational convolution, the GNN layer of ULTRA.

Counterpart of ``ultra_tpu/models/layers.py``: one Bellman-Ford round over
node-major ``(V, B, D)`` states. Parameters live in a module whose names are
the reference checkpoint's (``linear``, ``layer_norm``, ``relation``,
``relation_projection.{0,2}``, ``relation_linear``), so a reference
``state_dict`` loads as it is.

The ``sum`` and ``mean`` aggregators are ported; ``max``, ``pna`` and the
``rotate`` message are ROADMAP A8 and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ultra_tpu_torch.graph import Graph
from ultra_tpu_torch.ops.rspmm import degree, rspmm_from_graph

_MESSAGE2MUL = {"transe": "add", "distmult": "mul"}


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    input_dim: int = 64
    output_dim: int = 64
    num_relation: int = 4
    message_func: str = "distmult"  # distmult | transe
    aggregate_func: str = "sum"  # sum | mean
    layer_norm: bool = True
    activation: str = "relu"
    dependent: bool = False
    project_relations: bool = False


class GeneralizedRelationalConv(nn.Module):
    """One conv layer; ``forward`` is the JAX package's ``conv_apply``."""

    def __init__(self, cfg: ConvConfig):
        super().__init__()
        if cfg.message_func not in _MESSAGE2MUL:
            raise NotImplementedError(
                f"message_func {cfg.message_func!r} is not ported yet (ROADMAP A8)"
            )
        if cfg.aggregate_func not in ("sum", "mean"):
            raise NotImplementedError(
                f"aggregate_func {cfg.aggregate_func!r} is not ported yet (ROADMAP A8)"
            )
        self.cfg = cfg
        d_in, d_out = cfg.input_dim, cfg.output_dim
        self.linear = nn.Linear(2 * d_in, d_out)
        if cfg.layer_norm:
            self.layer_norm = nn.LayerNorm(d_out, eps=1e-5)
        if cfg.dependent:
            self.relation_linear = nn.Linear(d_in, cfg.num_relation * d_in)
        elif cfg.project_relations:
            self.relation_projection = nn.Sequential(
                nn.Linear(d_in, d_in), nn.ReLU(), nn.Linear(d_in, d_in)
            )
        else:
            self.relation = nn.Embedding(cfg.num_relation, d_in)

    def layer_relation(self, query=None, relation_input=None):
        """Per-layer relation features, (R, B, D).

        - dependent: project the (B, D) query to (R, B, D);
        - project_relations: an MLP on the injected (B, R, D) relation
          representations (the relation graph's output);
        - default: the layer's (R, D) embedding broadcast over the batch.
        """
        cfg = self.cfg
        if cfg.dependent:
            b = query.shape[0]
            rel = self.relation_linear(query).view(b, cfg.num_relation, cfg.input_dim)
            return rel.transpose(0, 1)
        if cfg.project_relations:
            return self.relation_projection(relation_input).transpose(0, 1)
        rel = self.relation.weight
        return rel[:, None, :].expand(rel.shape[0], query.shape[0], rel.shape[1])

    def forward(
        self,
        graph: Graph,
        input: torch.Tensor,  # (V, B, D) node states
        boundary: torch.Tensor,  # (V, B, D) layer-0 boundary condition
        query: torch.Tensor = None,  # (B, D) query embeddings
        relation_input: torch.Tensor = None,  # (B, R, D) injected relation reprs
    ) -> torch.Tensor:
        """One message-passing round; returns (V, B, output_dim)."""
        cfg = self.cfg
        relation = self.layer_relation(query, relation_input)
        update = rspmm_from_graph(
            graph, relation, input, sum="add", mul=_MESSAGE2MUL[cfg.message_func]
        )
        update = update + boundary
        if cfg.aggregate_func == "mean":
            update = update / (degree(graph, include_self_loop=False)[:, None, None] + 1.0)
        output = self.linear(torch.cat([input, update], dim=-1))
        if cfg.layer_norm:
            output = self.layer_norm(output)
        if cfg.activation:
            output = getattr(F, cfg.activation)(output)
        return output
