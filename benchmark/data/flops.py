"""The model's operations for the work a run completes, for ``mfu``.

Counted as the benchmark defines them, from the configuration's widths and
the graph's sizes: 3 operations per live edge and feature of each rspmm
(a multiply, the edge weight's multiply, an add), 2 * in * out per row of
each matrix product (a conv's ``linear``, the entity model's relation
projection, the scoring MLP). Elementwise work (layer norm, activations,
short cuts, the boundary) is not counted. A query counts once however the
program batches it, and a pass the program runs for no query counts
nothing.
"""

from __future__ import annotations


def _layers(model: dict):
    dims = [model["input_dim"]] + list(model["hidden_dims"])
    return list(zip(dims[:-1], dims[1:]))


def relation_query_flops(cfg: dict, rel_nodes: int, rel_edges: int) -> int:
    """One query relation through the relation model (on the graph of
    relations, ``rel_nodes`` nodes and ``rel_edges`` live edges)."""
    total = 0
    for d_in, d_out in _layers(cfg["relation_model"]):
        total += 3 * rel_edges * d_in + 2 * rel_nodes * (2 * d_in) * d_out
    return total


def entity_query_flops(cfg: dict, nodes: int, edges: int, relations: int,
                       score: bool = True) -> int:
    """One query through the entity model over a graph of ``nodes`` nodes,
    ``edges`` live edges and ``relations`` relation types: each layer's
    rspmm and ``linear``, the relation projection of every relation (two
    d x d products, where the configuration projects relations) and, with
    ``score``, the scoring MLP over every node."""
    model = cfg["entity_model"]
    total = 0
    for d_in, d_out in _layers(model):
        total += 3 * edges * d_in + 2 * nodes * (2 * d_in) * d_out
        if model.get("project_relations"):
            total += 2 * 2 * relations * d_in * d_in
    if score:
        feat = model["hidden_dims"][-1] + model["input_dim"]
        widths = [feat] * model["num_mlp_layer"] + [1]
        total += sum(2 * nodes * a * b for a, b in zip(widths[:-1], widths[1:]))
    return total
