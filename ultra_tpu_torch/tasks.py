"""Relation-graph construction and ranking.

Counterpart of ``ultra_tpu/tasks.py`` (the parts the serving slice runs).
The relation graph is built on the host with numpy; ranking runs on the
scores' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ultra_tpu_torch.graph import Graph, make_graph


def compute_ranking(pred, target, mask=None):
    """rank = 1 + #{candidates scoring >= the positive}; ties count against
    the positive (``pos <= pred``). ``mask`` (B, V) keeps the candidates
    that count (filtered ranking)."""
    pos_pred = pred.gather(-1, target[..., None])
    geq = pos_pred <= pred
    if mask is not None:
        geq = geq & mask
    return geq.sum(dim=-1) + 1


def build_relation_graph_arrays(edge_index, edge_type, num_nodes, num_relations, live=None):
    """Edges of the graph of relations, with 4 meta-relation types
    h2h=0, t2t=1, h2t=2, t2h=3.

    Two relations are joined when they share a node in the given roles:
    the nonzero pattern of the reference's sparse products E_x^T E_y, as a
    per-node join of the distinct (node, relation) incidence pairs.
    Returns (edge_index (2, M), edge_type (M,)) with relation ids as nodes.
    ``live``: optional boolean mask over edges.
    """
    ei = np.asarray(edge_index, dtype=np.int64)
    et = np.asarray(edge_type, dtype=np.int64)
    if live is not None:
        keep = np.asarray(live, dtype=bool)
        ei, et = ei[:, keep], et[keep]

    def incidence(nodes):
        # distinct (node, rel) pairs, sorted by node
        uniq = np.unique(nodes * num_relations + et)
        return uniq // num_relations, uniq % num_relations

    h_node, h_rel = incidence(ei[0])
    t_node, t_rel = incidence(ei[1])

    def join(a_node, a_rel, b_node, b_rel):
        """Pairs (ra, rb) sharing a node: for every a-entry, emit its node's
        whole b-group (a ragged cross product via arange minus offsets)."""
        ib = np.searchsorted(b_node, np.arange(num_nodes), side="left")
        cb_per_node = np.searchsorted(b_node, np.arange(num_nodes), side="right") - ib
        counts = cb_per_node[a_node]
        total = int(counts.sum())
        offsets = np.cumsum(counts) - counts
        r = (
            np.arange(total, dtype=np.int64)
            - np.repeat(offsets, counts)
            + np.repeat(ib[a_node], counts)
        )
        uniq = np.unique(np.repeat(a_rel, counts) * num_relations + b_rel[r])
        return np.stack([uniq // num_relations, uniq % num_relations])

    parts = [
        join(h_node, h_rel, h_node, h_rel),  # h2h
        join(t_node, t_rel, t_node, t_rel),  # t2t
        join(h_node, h_rel, t_node, t_rel),  # h2t
        join(t_node, t_rel, h_node, h_rel),  # t2h
    ]
    rel_edge_index = np.concatenate(parts, axis=1)
    rel_edge_type = np.concatenate(
        [np.full(p.shape[1], i) for i, p in enumerate(parts)]
    )
    return rel_edge_index.astype(np.int64), rel_edge_type.astype(np.int64)


def build_relation_graph(
    edge_index, edge_type, num_nodes, num_relations, device="cuda"
) -> Graph:
    """The relation graph (num_nodes = num_relations, 4 relation types)."""
    rei, ret = build_relation_graph_arrays(edge_index, edge_type, num_nodes, num_relations)
    return make_graph(
        rei, ret, num_nodes=num_relations, num_relations=4, device=device
    )
