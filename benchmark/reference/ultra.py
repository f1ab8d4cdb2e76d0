"""ULTRA's forward in plain PyTorch, float32, the reference of the cells.

Written from the published model (Galkin et al., ICLR 2024; the NBFNet
layer of Zhu et al., NeurIPS 2021) and the benchmark's configuration files,
with nothing of the program: RelNBFNet on the graph of relations, EntityNBFNet
(or UltraQuery's QueryNBFNet) on the entity graph, the scoring MLP. A
message is ``relation[type] * x[source]`` (distmult), summed into its
destination with ``index_add_`` over blocks of edges; each layer is
``relu(layer_norm(linear([x | messages + boundary])))`` with a short cut.
An edge ``(h, r, t)`` listed as ``edge_index[:, e] = (h, t)`` sends its
message from t into h: the direction of the published implementation's
fused rspmm kernel, which every published configuration runs.

A graph here is a dict of its raw arrays on the device: ``dst`` and ``src``
(E,) int64, ``etype`` (E,), ``num_nodes``, ``num_relations``. Edges carry
no weight: every edge of a cell's graph is live.

Weights are a dict of tensors under the names of the published checkpoint
(:func:`param_specs`), which the benchmark makes from the seed and hands to
both sides.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# elements of one (E_block, B*D) message tensor: 2**28 f32 is 1 GiB
BLOCK_ELEMENTS = 1 << 28


def _dims(model: dict):
    dims = [model["input_dim"]] + list(model["hidden_dims"])
    return list(zip(dims[:-1], dims[1:]))


def param_specs(cfg: dict):
    """[(name, shape, init)] of the model: ``init`` is ("uniform", bound) for
    a linear layer's weight and bias (torch's default, bound 1/sqrt(fan
    in)), ("normal",) for an embedding, ("ones",) and ("zeros",) for a layer
    norm."""
    specs = []

    def linear(prefix, d_in, d_out):
        b = 1.0 / math.sqrt(d_in)
        specs.append((f"{prefix}.weight", (d_out, d_in), ("uniform", b)))
        specs.append((f"{prefix}.bias", (d_out,), ("uniform", b)))

    for side in ("relation_model", "entity_model"):
        model = cfg[side]
        for i, (d_in, d_out) in enumerate(_dims(model)):
            p = f"{side}.layers.{i}"
            linear(f"{p}.linear", 2 * d_in, d_out)
            specs.append((f"{p}.layer_norm.weight", (d_out,), ("ones",)))
            specs.append((f"{p}.layer_norm.bias", (d_out,), ("zeros",)))
            if model.get("project_relations"):
                linear(f"{p}.relation_projection.0", d_in, d_in)
                linear(f"{p}.relation_projection.2", d_in, d_in)
            else:
                specs.append((f"{p}.relation.weight", (model["num_relation"], d_in), ("normal",)))
    ent = cfg["entity_model"]
    feat = ent["hidden_dims"][-1] + ent["input_dim"]
    widths = [feat] * ent["num_mlp_layer"] + [1]
    for j, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        linear(f"entity_model.mlp.{2 * j}", a, b)
    return specs


def rspmm(graph: dict, relation, x):
    """(V, B, D): out[dst] += relation[etype] * x[src] over every edge.
    ``relation`` (R, B, D), ``x`` (N, B, D)."""
    out = torch.zeros((graph["num_nodes"],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    edges = graph["dst"].numel()
    block = max(1, BLOCK_ELEMENTS // max(1, x[0].numel()))
    for lo in range(0, edges, block):
        dst, src, et = (graph[k][lo:lo + block] for k in ("dst", "src", "etype"))
        out.index_add_(0, dst, relation[et] * x[src])
    return out


def conv(w: dict, prefix: str, graph: dict, x, boundary, relation):
    """One layer: relu(layer_norm(linear([x | rspmm + boundary])))."""
    update = rspmm(graph, relation, x) + boundary
    out = F.linear(torch.cat([x, update], dim=-1), w[f"{prefix}.linear.weight"],
                   w[f"{prefix}.linear.bias"])
    out = F.layer_norm(out, out.shape[-1:], w[f"{prefix}.layer_norm.weight"],
                       w[f"{prefix}.layer_norm.bias"], eps=1e-5)
    return F.relu(out)


def bellman_ford(w: dict, side: str, model: dict, graph: dict, boundary, relation_of_layer):
    """The last hidden state (V, B, D) of the layers from ``boundary``;
    ``relation_of_layer(i)`` gives layer i's (R, B, D) relation features."""
    x = boundary
    for i in range(len(model["hidden_dims"])):
        out = conv(w, f"{side}.layers.{i}", graph, x, boundary, relation_of_layer(i))
        if model["short_cut"] and out.shape == x.shape:
            out = out + x
        x = out
    return x


def relation_representations(w: dict, cfg: dict, rel_graph: dict, rels):
    """(B, R, D): RelNBFNet on the graph of relations, from a boundary of
    ones on each query relation's node."""
    model = cfg["relation_model"]
    b, d = rels.numel(), model["input_dim"]
    boundary = torch.zeros(rel_graph["num_nodes"], b, d, device=rels.device)
    boundary[rels, torch.arange(b, device=rels.device)] = 1.0

    def relation(i):
        emb = w[f"relation_model.layers.{i}.relation.weight"]
        return emb[:, None, :].expand(emb.shape[0], b, emb.shape[1])

    return bellman_ford(w, "relation_model", model, rel_graph, boundary, relation).transpose(0, 1)


def _projected(w: dict, i: int, rel_repr):
    """Layer i's relation features (R, B, D) from (B, R, D) representations."""
    p = f"entity_model.layers.{i}.relation_projection"
    hidden = F.relu(F.linear(rel_repr, w[f"{p}.0.weight"], w[f"{p}.0.bias"]))
    return F.linear(hidden, w[f"{p}.2.weight"], w[f"{p}.2.bias"]).transpose(0, 1)


def entity_scores(w: dict, cfg: dict, graph: dict, rel_repr, boundary, query):
    """(B, V) logits: EntityNBFNet from ``boundary`` (V, B, D) with relation
    features projected from ``rel_repr`` (B, R, D), then the scoring MLP on
    [last hidden | query]."""
    model = cfg["entity_model"]
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


def score_all(w: dict, cfg: dict, graph: dict, rel_repr, heads, query_rels):
    """(B, V) logits of every node as the answer of (head, query relation)
    rows: the boundary is the query vector ``rel_repr[b, query_rels[b]]`` on
    node ``heads[b]``."""
    b = heads.numel()
    rows = torch.arange(b, device=heads.device)
    query = rel_repr[rows, query_rels]
    boundary = torch.zeros(graph["num_nodes"], b, query.shape[-1], device=heads.device)
    boundary.index_put_((heads, rows), query, accumulate=True)
    return entity_scores(w, cfg, graph, rel_repr, boundary, query)
