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
from ultra_tpu_torch.ops import mlp_score_cuda


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
    set, so duplicate heads accumulate as the reference's ``scatter_add_``.

    Its callers that run a model on it, :func:`_entity_hiddens` and
    :func:`rel_nbfnet_apply`, also hand its nonzero rows to
    :func:`bellmanford` (:func:`boundary_rows`): layer 0's input and its
    short cut read this dense tensor, and each sum or mean conv adds the
    rows alone, the same bits (``layers.py``, ``_update``)."""
    b, d = query.shape
    boundary = torch.zeros(num_nodes, b, d, dtype=query.dtype, device=query.device)
    batch = torch.arange(b, device=query.device)
    return boundary.index_put_((h_index, batch), query, accumulate=True)


def boundary_rows(h_index, query, num_nodes: int):
    """The nonzero rows of ``scatter_boundary(h_index, query, num_nodes)``:
    (flat indices ``h_index * B + arange(B)`` into its (V*B, D) view,
    ``query``). The batch index makes the B indices distinct, whatever the
    heads. They are int32 wherever the view's rows allow: PyTorch's CPU
    ``index_add_`` hands an int64 index to ``scatter_add_``, whose threads
    cost milliseconds a call on a busy host (the card takes either)."""
    b = query.shape[0]
    dtype = torch.int32 if num_nodes * b <= torch.iinfo(torch.int32).max else torch.int64
    batch = torch.arange(b, dtype=dtype, device=query.device)
    return torch.add(batch, h_index, alpha=b, out=torch.empty_like(batch)), query


def bellmanford(
    model: NBFNet,
    graph: Graph,
    boundary,  # (V, B, D)
    query,  # (B, D)
    relation_input=None,  # (B, R, D) for project_relations
    rows=None,  # boundary_rows(...) where ``boundary`` is scatter_boundary(...)
):
    """Run every conv layer with the original boundary condition and
    residual short-cuts between equal-width layers; returns all hidden
    states. Each conv adds its short cut itself (``residual``), so that at
    inference one kernel ends the layer (``layers.py``). With
    ``cfg.remat`` and a gradient wanted, each conv is recomputed in the
    backward instead of keeping its activations.

    ``rows``, the boundary's nonzero rows (:func:`boundary_rows`), come
    from the entity and relation models' callers, whose boundary is
    scattered: each sum or mean conv then adds those B rows in place of the
    dense (V, B, D) boundary, the same bits, since every other row of it is
    zeros (``layers.py``, ``_update``). Without them (UltraQuery's fuzzy
    sets) every conv adds the dense boundary."""
    layer_input = boundary
    hiddens = []
    remat = model.cfg.remat and torch.is_grad_enabled()
    for conv in model.layers:
        residual = (layer_input if model.cfg.short_cut
                    and layer_input.shape[-1] == conv.cfg.output_dim else None)
        if remat:
            hidden = checkpoint(conv, graph, layer_input, boundary, query, relation_input,
                                residual=residual, rows=rows, use_reentrant=False)
        else:
            hidden = conv(graph, layer_input, boundary, query, relation_input,
                          residual=residual, rows=rows)
        hiddens.append(hidden)
        layer_input = hidden
    return hiddens


def rel_nbfnet_apply(model: NBFNet, rel_graph: Graph, query_rels):
    """query_rels: (B,) relation ids. Returns (B, R, D) relation states; the
    boundary is an all-ones vector on the query relation's node."""
    b, d = query_rels.shape[0], model.cfg.input_dim
    query = torch.ones(b, d, dtype=torch.float32, device=query_rels.device)
    boundary = scatter_boundary(query_rels, query, rel_graph.num_nodes)
    hiddens = bellmanford(model, rel_graph, boundary, query,
                          rows=boundary_rows(query_rels, query, rel_graph.num_nodes))
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
    return _features(model, *_entity_hiddens(model, graph, relation_representations,
                                             h_index, r_index))


def _entity_hiddens(model: NBFNet, graph: Graph, relation_representations, h_index, r_index):
    """Bellman-Ford on the entity graph for (h, r) rows of shape (B,), from
    the boundary of each row's query at its head: (every layer's (V, B, D)
    hidden state, the queries (B, D))."""
    b = h_index.shape[0]
    batch = torch.arange(b, device=h_index.device)
    query = relation_representations[batch, r_index]  # (B, D)
    boundary = scatter_boundary(h_index, query, graph.num_nodes)
    hiddens = bellmanford(model, graph, boundary, query,
                          relation_input=relation_representations,
                          rows=boundary_rows(h_index, query, graph.num_nodes))
    return hiddens, query


def _features(model: NBFNet, hiddens, query):
    """(V, B, F) [last hidden (or every hidden) ‖ query] of each node."""
    node_query = query.expand(hiddens[-1].shape[0], *query.shape)
    if model.cfg.concat_hidden:
        return torch.cat(hiddens + [node_query], dim=-1)
    return torch.cat([hiddens[-1], node_query], dim=-1)


def _score_nodes(model: NBFNet, hiddens, query):
    """(B, V) logits of the scoring MLP over every node's features: one
    ``mlp_score_cuda.mlp_score`` call (S1, one kernel on the card) where
    :func:`_scorer_fused` takes it, else ``model.mlp`` over
    :func:`_features`, whose autograd graph training and attribution need."""
    if _scorer_fused(model, hiddens[-1], query):
        first, last = model.mlp[0], model.mlp[2]
        return mlp_score_cuda.mlp_score(hiddens[-1], query, first.weight, first.bias,
                                        last.weight, last.bias).T
    return model.mlp(_features(model, hiddens, query)).squeeze(-1).T


def _scorer_fused(model: NBFNet, hidden, query) -> bool:
    """Whether S1 computes the scores: where no gradient is wanted, the
    features are the last hidden state and the query alone (no
    ``concat_hidden``), the MLP is two linears with a ReLU between them, and
    S1 takes their operands (``mlp_score_cuda.takes``: its widths, batch,
    dtype and layout). The CPU takes it too: there the call is the composed
    ops' twin, the same bits."""
    mlp = model.mlp
    if model.cfg.concat_hidden or [type(m) for m in mlp] != [nn.Linear, nn.ReLU, nn.Linear]:
        return False
    first, last = mlp[0], mlp[2]
    operands = (hidden, query, first.weight, first.bias, last.weight, last.bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        return False
    return mlp_score_cuda.takes(*operands)


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
    return _score_nodes(model, *_entity_hiddens(model, graph, relation_representations,
                                                h_index, r_index))


def query_nbfnet_apply(
    model: NBFNet, graph: Graph, node_features, relation_representations, query
):
    """UltraQuery's entity reasoner (QueryNBFNet, ``models.py:258-275`` of the
    reference): Bellman-Ford from the dense (V, B, D) boundary
    ``node_features`` (a fuzzy set of nodes times the query), with
    ``relation_representations`` (B, R, D) as the relation input, then the
    MLP on [last hidden ‖ query] (B, D). Returns (B, V) scores. UltraQuery
    runs it with an :class:`Ultra`'s ``entity_model``."""
    hiddens = bellmanford(model, graph, node_features, query,
                          relation_input=relation_representations)
    return _score_nodes(model, hiddens, query)


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
