"""Edge matching, negative sampling, easy-edge masks, relation-graph
construction and ranking.

Counterpart of ``ultra_tpu/tasks.py``. Edge matching, sampling, masks and
the relation graph are host work in numpy, with the JAX package's
arithmetic, so one ``np.random.Generator`` gives the same batches in both
packages; ranking and ``all_negative`` run on the scores' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ultra_tpu_torch.graph import Graph, make_graph


class EdgeMatcher:
    """Radix-hash lookup over a set of edges, built once per graph: k-column
    int tuples hash into int64 (overflow-checked), sorted once; queries are
    vectorised searchsorted."""

    def __init__(self, columns: np.ndarray):
        cols = np.asarray(columns, dtype=np.int64)  # (k, E)
        base = cols.max(axis=1) + 1
        assert int(np.prod(base.astype(object))) < np.iinfo(np.int64).max
        scale = np.cumprod(base)
        self.scale = (scale[-1] // scale).astype(np.int64)
        edge_hash = (cols * self.scale[:, None]).sum(axis=0)
        self.order = np.argsort(edge_hash, kind="stable")
        self.sorted_hash = edge_hash[self.order]

    def query(self, query_cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(edge ids of every edge matching each query tuple, concatenated;
        per-query match counts)."""
        q = np.asarray(query_cols, dtype=np.int64)
        query_hash = (q * self.scale[:, None]).sum(axis=0)
        start = np.searchsorted(self.sorted_hash, query_hash, side="left")
        end = np.searchsorted(self.sorted_hash, query_hash, side="right")
        num_match = end - start
        offset = np.cumsum(num_match) - num_match
        rng = np.arange(num_match.sum(), dtype=np.int64)
        rng = rng + np.repeat(start - offset, num_match)
        return self.order[rng], num_match


class GraphIndex(NamedTuple):
    """Host companion of a Graph: its live edges and their match tables."""

    edge_index: np.ndarray  # (2, E) live edges only (no padding)
    edge_type: np.ndarray  # (E,)
    num_nodes: int
    num_relations: int
    hr_matcher: EdgeMatcher  # keyed (head, type): true tails
    tr_matcher: EdgeMatcher  # keyed (tail, type): true heads
    htr_matcher: EdgeMatcher  # keyed (head, tail, type): easy-edge removal
    ht_matcher: EdgeMatcher  # keyed (head, tail): remove_one_hop

    @classmethod
    def build(cls, edge_index, edge_type, num_nodes, num_relations) -> "GraphIndex":
        ei = np.asarray(edge_index, dtype=np.int64)
        et = np.asarray(edge_type, dtype=np.int64)
        return cls(
            edge_index=ei,
            edge_type=et,
            num_nodes=int(num_nodes),
            num_relations=int(num_relations),
            hr_matcher=EdgeMatcher(np.stack([ei[0], et])),
            tr_matcher=EdgeMatcher(np.stack([ei[1], et])),
            htr_matcher=EdgeMatcher(np.vstack([ei, et[None]])),
            ht_matcher=EdgeMatcher(ei),
        )


def strict_negative_mask(index: GraphIndex, batch: np.ndarray):
    """(t_mask, h_mask): (B, V) bool, False on every true tail of (h, r),
    every true head of (t, r) and on the positive itself."""
    batch = np.asarray(batch)
    h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
    bsz = len(batch)

    edge_id, num_t = index.hr_matcher.query(np.stack([h, r]))
    t_truth = index.edge_index[1, edge_id]
    sample_id = np.repeat(np.arange(bsz), num_t)
    t_mask = np.ones((bsz, index.num_nodes), dtype=bool)
    t_mask[sample_id, t_truth] = False
    t_mask[np.arange(bsz), t] = False

    edge_id, num_h = index.tr_matcher.query(np.stack([t, r]))
    h_truth = index.edge_index[0, edge_id]
    sample_id = np.repeat(np.arange(bsz), num_h)
    h_mask = np.ones((bsz, index.num_nodes), dtype=bool)
    h_mask[sample_id, h_truth] = False
    h_mask[np.arange(bsz), h] = False
    return t_mask, h_mask


def _draw(mask: np.ndarray, num_negative: int, rng: np.random.Generator) -> np.ndarray:
    """num_negative candidates per row, uniform over the row's True slots."""
    candidate = np.nonzero(mask)[1]
    num_candidate = mask.sum(axis=-1)
    rand = rng.random((len(mask), num_negative))
    idx = (rand * num_candidate[:, None]).astype(np.int64)
    idx = idx + (np.cumsum(num_candidate) - num_candidate)[:, None]
    return candidate[idx]


def negative_sampling(
    index: GraphIndex,
    batch: np.ndarray,
    num_negative: int,
    strict: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(B, 1+num_negative, 3): the first half of the batch gets corrupted
    tails, the second half corrupted heads; slot 0 is the positive."""
    rng = rng or np.random.default_rng()
    batch = np.asarray(batch)
    bsz = len(batch)
    h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
    if strict:
        t_mask, h_mask = strict_negative_mask(index, batch)
        neg_t_index = _draw(t_mask[: bsz // 2], num_negative, rng)
        neg_h_index = _draw(h_mask[bsz // 2:], num_negative, rng)
    else:
        neg = rng.integers(0, index.num_nodes, size=(bsz, num_negative))
        neg_t_index, neg_h_index = neg[: bsz // 2], neg[bsz // 2:]

    h_index = np.repeat(h[:, None], num_negative + 1, axis=1)
    t_index = np.repeat(t[:, None], num_negative + 1, axis=1)
    r_index = np.repeat(r[:, None], num_negative + 1, axis=1)
    t_index[: bsz // 2, 1:] = neg_t_index
    h_index[bsz // 2:, 1:] = neg_h_index
    return np.stack([h_index, t_index, r_index], axis=-1)


def easy_edge_weights(
    index: GraphIndex,
    batch: np.ndarray,
    num_edges_padded: int,
    remove_one_hop: bool = False,
) -> np.ndarray:
    """(E_pad,) float32 of 1s and 0s: the batch's (h, r, t) edges and their
    inverses (or, with ``remove_one_hop``, every edge between h and t) and
    the padding are 0. The graph's weight mask for one training batch."""
    batch = np.asarray(batch)
    if batch.ndim == 3:
        h, t, r = batch[:, 0, 0], batch[:, 0, 1], batch[:, 0, 2]
    else:
        h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
    h_ext = np.concatenate([h, t])
    t_ext = np.concatenate([t, h])
    r_ext = np.concatenate([r, r + index.num_relations // 2])
    if remove_one_hop:
        edge_id, _ = index.ht_matcher.query(np.stack([h_ext, t_ext]))
    else:
        edge_id, _ = index.htr_matcher.query(np.stack([h_ext, t_ext, r_ext]))
    w = np.ones(num_edges_padded, dtype=np.float32)
    w[index.edge_index.shape[1]:] = 0.0  # padding stays dead
    w[edge_id] = 0.0
    return w


def all_negative(num_nodes: int, batch: torch.Tensor):
    """(t_batch, h_batch), each (B, V, 3): every node as the tail, and every
    node as the head, of each (h, t, r) row."""
    h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
    b = batch.shape[0]
    all_idx = torch.arange(num_nodes, dtype=batch.dtype, device=batch.device).expand(b, -1)
    expand = lambda a: a[:, None].expand(b, num_nodes)
    t_batch = torch.stack([expand(h), all_idx, expand(r)], dim=-1)
    h_batch = torch.stack([all_idx, expand(t), expand(r)], dim=-1)
    return t_batch, h_batch


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
