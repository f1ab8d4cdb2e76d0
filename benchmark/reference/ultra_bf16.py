"""ULTRA's forward with bf16 rspmm operands, in plain PyTorch float32: the
reference of the cells whose configuration sets ``compute_dtype: bfloat16``.

The model of ``reference/ultra.py`` (whose message passing and relation
projection it takes, and whose weights' names it reads), with one rounding:
each layer of both models rounds its input ``x`` and its relation features
to bf16 (round to nearest even) and widens them back to float32, then runs
the message passing and the concatenation on the rounded values. Everything
else is float32 as in ``reference/ultra.py``: the boundary, the ``linear``,
the layer norm, the short cut (which adds the unrounded ``x``), the relation
projection and the scoring MLP. That is the precision the configuration's
``compute_dtype: bfloat16`` names: the operands of the sparse product in
bf16, its sums in float32, the rest in float32.

Departure: a bf16 product of two bf16 values is exact in float32, so the
messages are the same values on both sides; their sums into a node are
float32 in an order of this file's own (``index_add_`` over blocks of
edges), not in the program's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.ultra import _projected, rspmm


def to_bf16(t):
    """``t`` rounded to bf16 (round to nearest even) and widened back."""
    return t.to(torch.bfloat16).float()


def conv(w: dict, prefix: str, graph: dict, x, boundary, relation):
    """One layer: relu(layer_norm(linear([x' | rspmm(r', x') + boundary])))
    with x' and r' the layer's input and relation features rounded to bf16."""
    x16, rel16 = to_bf16(x), to_bf16(relation)
    update = rspmm(graph, rel16, x16) + boundary
    out = F.linear(torch.cat([x16, update], dim=-1), w[f"{prefix}.linear.weight"],
                   w[f"{prefix}.linear.bias"])
    out = F.layer_norm(out, out.shape[-1:], w[f"{prefix}.layer_norm.weight"],
                       w[f"{prefix}.layer_norm.bias"], eps=1e-5)
    return F.relu(out)


def bellman_ford(w: dict, side: str, model: dict, graph: dict, boundary, relation_of_layer):
    """The last hidden state (V, B, D); the short cut adds the unrounded
    input of each layer."""
    x = boundary
    for i in range(len(model["hidden_dims"])):
        out = conv(w, f"{side}.layers.{i}", graph, x, boundary, relation_of_layer(i))
        if model["short_cut"] and out.shape == x.shape:
            out = out + x
        x = out
    return x


def relation_representations(w: dict, cfg: dict, rel_graph: dict, rels):
    """(B, R, D): RelNBFNet, as ``reference/ultra.py`` with this file's layer."""
    model = cfg["relation_model"]
    b, d = rels.numel(), model["input_dim"]
    boundary = torch.zeros(rel_graph["num_nodes"], b, d, device=rels.device)
    boundary[rels, torch.arange(b, device=rels.device)] = 1.0

    def relation(i):
        emb = w[f"relation_model.layers.{i}.relation.weight"]
        return emb[:, None, :].expand(emb.shape[0], b, emb.shape[1])

    return bellman_ford(w, "relation_model", model, rel_graph, boundary, relation).transpose(0, 1)


def score_all(w: dict, cfg: dict, graph: dict, rel_repr, heads, query_rels):
    """(B, V) logits, as ``reference/ultra.py::score_all`` with this file's
    layer; the scoring MLP in float32."""
    model = cfg["entity_model"]
    b = heads.numel()
    rows = torch.arange(b, device=heads.device)
    query = rel_repr[rows, query_rels]
    boundary = torch.zeros(graph["num_nodes"], b, query.shape[-1], device=heads.device)
    boundary.index_put_((heads, rows), query, accumulate=True)
    hidden = bellman_ford(w, "entity_model", model, graph, boundary,
                          lambda i: _projected(w, i, rel_repr))
    feature = torch.cat([hidden, query.expand(graph["num_nodes"], *query.shape)], dim=-1)
    n = model["num_mlp_layer"]
    for j in range(n):
        feature = F.linear(feature, w[f"entity_model.mlp.{2 * j}.weight"],
                           w[f"entity_model.mlp.{2 * j}.bias"])
        if j < n - 1:
            feature = F.relu(feature)
    return feature.squeeze(-1).T
