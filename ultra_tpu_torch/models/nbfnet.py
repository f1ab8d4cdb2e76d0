"""RelNBFNet (on the relation graph), EntityNBFNet (on the entity graph) and
their composition, Ultra.

Counterpart of ``ultra_tpu/models/nbfnet.py``. :class:`NBFNet` and
:class:`Ultra` hold the parameters under the reference checkpoint's names
(``relation_model.layers.{i}.*``, ``entity_model.layers.{i}.*``,
``entity_model.mlp.{0,2}.*``); the functions below take a module where the
JAX functions take a parameter tree, and keep the node-major ``(V, B, D)``
activation layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ultra_tpu_torch.graph import Graph
from ultra_tpu_torch.models.layers import (
    ConvConfig, GeneralizedRelationalConv, check_compute_dtype,
)


@dataclasses.dataclass(frozen=True)
class NBFNetConfig:
    input_dim: int = 64
    hidden_dims: Tuple[int, ...] = (64, 64, 64, 64, 64, 64)
    num_relation: int = 4  # 4 meta-relations for RelNBFNet; unused for Entity
    message_func: str = "distmult"
    aggregate_func: str = "sum"
    short_cut: bool = True
    layer_norm: bool = True
    activation: str = "relu"
    concat_hidden: bool = False
    num_mlp_layer: int = 2
    # training masks every edge between a batch's head and tail, not only
    # its (h, r, t) edges and their inverses (tasks.easy_edge_weights)
    remove_one_hop: bool = False
    project_relations: bool = False
    # recompute each conv in the backward instead of keeping its activations
    # (torch.utils.checkpoint): O(V*B*D) live memory per stack instead of per
    # layer, for one more forward
    remat: bool = False
    # "bfloat16": each conv's rspmm operands in bf16, f32 accumulation
    # (layers.py); None or "float32": f32
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        check_compute_dtype(self.compute_dtype)

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.input_dim,) + tuple(self.hidden_dims)

    def conv_config(self, i: int) -> ConvConfig:
        return ConvConfig(
            input_dim=self.dims[i],
            output_dim=self.dims[i + 1],
            num_relation=self.num_relation,
            message_func=self.message_func,
            aggregate_func=self.aggregate_func,
            layer_norm=self.layer_norm,
            activation=self.activation,
            dependent=False,
            project_relations=self.project_relations,
            compute_dtype=self.compute_dtype,
        )


@dataclasses.dataclass(frozen=True)
class UltraConfig:
    relation_model: NBFNetConfig = dataclasses.field(
        default_factory=lambda: NBFNetConfig(num_relation=4)
    )
    entity_model: NBFNetConfig = dataclasses.field(
        default_factory=lambda: NBFNetConfig(num_relation=1, project_relations=True)
    )


class NBFNet(nn.Module):
    """Conv stack (``layers``) and, with ``score_mlp``, the scoring MLP
    (``mlp``: Linear-ReLU-...-Linear to one logit)."""

    def __init__(self, cfg: NBFNetConfig, score_mlp: bool = False):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            GeneralizedRelationalConv(cfg.conv_config(i))
            for i in range(len(cfg.hidden_dims))
        )
        if score_mlp:
            feature_dim = (
                sum(cfg.hidden_dims) if cfg.concat_hidden else cfg.hidden_dims[-1]
            ) + cfg.input_dim
            mlp = []
            for _ in range(cfg.num_mlp_layer - 1):
                mlp += [nn.Linear(feature_dim, feature_dim), nn.ReLU()]
            mlp.append(nn.Linear(feature_dim, 1))
            self.mlp = nn.Sequential(*mlp)


class Ultra(nn.Module):
    """RelNBFNet (``relation_model``) + EntityNBFNet (``entity_model``)."""

    def __init__(self, cfg: UltraConfig):
        super().__init__()
        self.cfg = cfg
        self.relation_model = NBFNet(cfg.relation_model)
        self.entity_model = NBFNet(cfg.entity_model, score_mlp=True)


def scatter_boundary(h_index, query, num_nodes: int):
    """(V, B, D) boundary: query[b] added onto node h_index[b] — add, not
    set, so duplicate heads accumulate as the reference's ``scatter_add_``."""
    b, d = query.shape
    boundary = torch.zeros(num_nodes, b, d, dtype=query.dtype, device=query.device)
    batch = torch.arange(b, device=query.device)
    return boundary.index_put_((h_index, batch), query, accumulate=True)


def bellmanford(
    model: NBFNet,
    graph: Graph,
    boundary,  # (V, B, D)
    query,  # (B, D)
    relation_input=None,  # (B, R, D) for project_relations
):
    """Run every conv layer with the original boundary condition and
    residual short-cuts between equal-width layers; returns all hidden
    states. With ``cfg.remat`` and a gradient wanted, each conv is
    recomputed in the backward instead of keeping its activations."""
    layer_input = boundary
    hiddens = []
    remat = model.cfg.remat and torch.is_grad_enabled()
    for conv in model.layers:
        if remat:
            hidden = checkpoint(conv, graph, layer_input, boundary, query, relation_input,
                                use_reentrant=False)
        else:
            hidden = conv(graph, layer_input, boundary, query, relation_input)
        if model.cfg.short_cut and hidden.shape == layer_input.shape:
            hidden = hidden + layer_input
        hiddens.append(hidden)
        layer_input = hidden
    return hiddens


def rel_nbfnet_apply(model: NBFNet, rel_graph: Graph, query_rels):
    """query_rels: (B,) relation ids. Returns (B, R, D) relation states; the
    boundary is an all-ones vector on the query relation's node."""
    b, d = query_rels.shape[0], model.cfg.input_dim
    query = torch.ones(b, d, dtype=torch.float32, device=query_rels.device)
    boundary = scatter_boundary(query_rels, query, rel_graph.num_nodes)
    hiddens = bellmanford(model, rel_graph, boundary, query)
    if model.cfg.concat_hidden:
        node_query = query.expand(rel_graph.num_nodes, b, d)
        output = model.mlp(torch.cat(hiddens + [node_query], dim=-1))
    else:
        output = hiddens[-1]
    return output.transpose(0, 1)


def negative_sample_to_tail(h_index, t_index, r_index, num_direct_rel: int):
    """Turn head-corruption rows into tail prediction under the inverse
    relation."""
    is_t_neg = (h_index == h_index[:, :1]).all(dim=-1, keepdim=True)
    new_h = torch.where(is_t_neg, h_index, t_index)
    new_t = torch.where(is_t_neg, t_index, h_index)
    new_r = torch.where(is_t_neg, r_index, r_index + num_direct_rel)
    return new_h, new_t, new_r


def entity_nbfnet_features(
    model: NBFNet, graph: Graph, relation_representations, h_index, r_index
):
    """Bellman-Ford on the entity graph for (h, r) rows of shape (B,).
    Returns (V, B, F) node features [last hidden ‖ query]."""
    b = h_index.shape[0]
    batch = torch.arange(b, device=h_index.device)
    query = relation_representations[batch, r_index]  # (B, D)
    boundary = scatter_boundary(h_index, query, graph.num_nodes)
    return _node_features(model, graph, boundary, query, relation_representations)


def _node_features(model: NBFNet, graph: Graph, boundary, query, relation_representations):
    """Bellman-Ford from ``boundary`` (V, B, D); returns (V, B, F) node
    features [last hidden (or every hidden) ‖ query]."""
    hiddens = bellmanford(
        model, graph, boundary, query, relation_input=relation_representations
    )
    node_query = query.expand(graph.num_nodes, *query.shape)
    if model.cfg.concat_hidden:
        return torch.cat(hiddens + [node_query], dim=-1)
    return torch.cat([hiddens[-1], node_query], dim=-1)


def entity_nbfnet_apply(
    model: NBFNet, graph: Graph, relation_representations, batch
):
    """batch (B, K, 3) of (h, t, r). Returns (B, K) logits."""
    h_index, t_index, r_index = batch[..., 0], batch[..., 1], batch[..., 2]
    h_index, t_index, r_index = negative_sample_to_tail(
        h_index, t_index, r_index, num_direct_rel=graph.num_relations // 2
    )
    feature = entity_nbfnet_features(
        model, graph, relation_representations, h_index[:, 0], r_index[:, 0]
    )  # (V, B, F)
    rows = torch.arange(feature.shape[1], device=feature.device)[:, None]
    return model.mlp(feature[t_index, rows]).squeeze(-1)


def entity_nbfnet_score_all(
    model: NBFNet, graph: Graph, relation_representations, h_index, r_index
):
    """(B, V) logits of every node as the tail of each (h, r) row."""
    feature = entity_nbfnet_features(
        model, graph, relation_representations, h_index, r_index
    )
    return model.mlp(feature).squeeze(-1).T


def query_nbfnet_apply(
    model: NBFNet, graph: Graph, node_features, relation_representations, query
):
    """UltraQuery's entity reasoner (QueryNBFNet, ``models.py:258-275`` of the
    reference): Bellman-Ford from the dense (V, B, D) boundary
    ``node_features`` (a fuzzy set of nodes times the query), with
    ``relation_representations`` (B, R, D) as the relation input, then the
    MLP on [last hidden ‖ query] (B, D). Returns (B, V) scores. UltraQuery
    runs it with an :class:`Ultra`'s ``entity_model``."""
    feature = _node_features(model, graph, node_features, query, relation_representations)
    return model.mlp(feature).squeeze(-1).T


def ultra_apply(model: Ultra, graph: Graph, batch):
    """batch (B, K, 3). Returns (B, K) scores."""
    rel_repr = rel_nbfnet_apply(model.relation_model, graph.relation_graph, batch[:, 0, 2])
    return entity_nbfnet_apply(model.entity_model, graph, rel_repr, batch)


def ultra_score_all(
    model: Ultra, graph: Graph, h_index, *, r_index, query_r_index: Optional[torch.Tensor] = None
):
    """(B, V) all-tail scores for (h, r) rows.

    ``query_r_index`` conditions the relation model and defaults to
    ``r_index``. Head prediction for (t, r) is
    ``ultra_score_all(h_index=t, r_index=r + R/2, query_r_index=r)``.
    """
    if query_r_index is None:
        query_r_index = r_index
    rel_repr = rel_nbfnet_apply(model.relation_model, graph.relation_graph, query_r_index)
    return entity_nbfnet_score_all(model.entity_model, graph, rel_repr, h_index, r_index)
