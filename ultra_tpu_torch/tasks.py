"""Edge matching, negative sampling, easy-edge masks, relation-graph
construction (and its masks under traversal dropout) and ranking.

Counterpart of ``ultra_tpu/tasks.py``. Edge matching, sampling, masks and
the relation graph are host work in numpy, with the JAX package's
arithmetic, so one ``np.random.Generator`` gives the same batches in both
packages; ranking and ``all_negative`` run on the scores' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ultra_tpu_torch import native
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
    Returns (edge_index (2, M), edge_type (M,)) with relation ids as nodes,
    ordered by type, then source, then destination. ``live``: optional
    boolean mask over edges. The native C++ join (``ultra_tpu_torch/native``)
    computes it where ``g++`` is found, else
    :func:`relation_graph_arrays_numpy`; both give the same arrays.
    """
    out = native.relgraph_build_native(edge_index, edge_type, num_nodes, num_relations, live)
    if out is not None:
        return out
    return relation_graph_arrays_numpy(edge_index, edge_type, num_nodes, num_relations, live)


def relation_graph_arrays_numpy(edge_index, edge_type, num_nodes, num_relations, live=None):
    """:func:`build_relation_graph_arrays` in numpy: the plain version of
    the native join, taken without a compiler."""
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


class RelGraphMasker:
    """The relation graph after traversal dropout, as a weight mask over the
    base relation graph's edges, in time linear in the dropped edges.

    Dropout only removes edges, and the relation graph's edges are monotone
    in the edges of the graph, so each dropout round's relation graph (the
    rebuild of ``ultraquery.py:201-203``) is a subset of the base one. The
    pairwise counts of shared incidences ``C[type][r1, r2]`` are taken once
    (four R x R products of the dense node-by-relation incidence matrices);
    a round applies the low-rank update

        C' = C - Rm^T M - M^T Rm + Rm^T Rm,

    where ``Rm`` holds the (node, relation) incidences the round's dropped
    edges empty (an incidence empties when all its edges drop). A base
    relation edge survives when its count stays positive. Weight 0 is an
    absent edge for every kernel, so the base relation graph's layouts serve
    every round. ``rel_edge_index`` and ``rel_edge_type`` must be the arrays
    the base relation graph was built from, in their order (by default
    :func:`build_relation_graph_arrays` of the edges, which is deterministic).
    """

    def __init__(self, edge_index, edge_type, num_nodes, num_relations,
                 rel_edge_index=None, rel_edge_type=None):
        ei = np.asarray(edge_index, dtype=np.int64)
        et = np.asarray(edge_type, dtype=np.int64)
        v, r = int(num_nodes), int(num_relations)
        self.num_relations = r
        # each edge's incidence keys, and each incidence's edge count
        self.hkey = ei[0] * r + et
        self.tkey = ei[1] * r + et
        self.hk_uniq, self.hk_cnt = np.unique(self.hkey, return_counts=True)
        self.tk_uniq, self.tk_cnt = np.unique(self.tkey, return_counts=True)
        # dense incidences (counts up to num_nodes < 2**24 are exact in f32)
        h = np.zeros((v, r), np.float32)
        h[ei[0], et] = 1.0
        t = np.zeros((v, r), np.float32)
        t[ei[1], et] = 1.0
        self.h_inc, self.t_inc = h, t
        if rel_edge_index is None:
            rel_edge_index, rel_edge_type = build_relation_graph_arrays(ei, et, v, r)
        self.rel_src = np.asarray(rel_edge_index[0], dtype=np.int64)
        self.rel_dst = np.asarray(rel_edge_index[1], dtype=np.int64)
        self.rel_type = np.asarray(rel_edge_type, dtype=np.int64)
        c = np.stack([h.T @ h, t.T @ t, h.T @ t, t.T @ h])  # h2h, t2t, h2t, t2h
        self.base_counts = c[self.rel_type, self.rel_src, self.rel_dst]
        assert (self.base_counts >= 1.0).all(), "base rel edge with zero count"

    @property
    def num_rel_edges(self) -> int:
        return len(self.rel_type)

    def edge_weights(self, dropped_ids: np.ndarray) -> np.ndarray:
        """(M,) float32 over the base relation graph's edges once the edges
        ``dropped_ids`` are dropped: 1.0 where an edge survives, else 0.0."""
        r = self.num_relations
        m = self.num_rel_edges
        dropped_ids = np.asarray(dropped_ids)
        if len(dropped_ids) == 0:
            return np.ones(m, np.float32)

        def emptied(keys, uq, cnt):
            dk, dcnt = np.unique(keys, return_counts=True)
            gone = dk[cnt[np.searchsorted(uq, dk)] == dcnt]
            return gone // r, gone % r

        hn, hr = emptied(self.hkey[dropped_ids], self.hk_uniq, self.hk_cnt)
        tn, tr = emptied(self.tkey[dropped_ids], self.tk_uniq, self.tk_cnt)
        if len(hn) == 0 and len(tn) == 0:
            return np.ones(m, np.float32)

        h, t = self.h_inc, self.t_inc
        # Rm_a^T Rm_b on removed-incidence matrices compacted to their nodes
        nodes = np.unique(np.concatenate([hn, tn]))
        rh = np.zeros((len(nodes), r), np.float32)
        rt = np.zeros((len(nodes), r), np.float32)
        rh[np.searchsorted(nodes, hn), hr] = 1.0
        rt[np.searchsorted(nodes, tn), tr] = 1.0

        def rows_accum2(rel_of_row, nodes_of_row):
            """Rm^T H and Rm^T T: the removed nodes' incidence rows summed
            onto their removed relation's row (a sort and a reduceat)."""
            out = np.zeros((r, 2 * r), np.float32)
            if len(rel_of_row) == 0:
                return out[:, :r], out[:, r:]
            order = np.argsort(rel_of_row, kind="stable")
            rel_s = rel_of_row[order]
            n_s = nodes_of_row[order]
            rows = np.concatenate([h[n_s], t[n_s]], axis=1)
            starts = np.nonzero(np.r_[True, rel_s[1:] != rel_s[:-1]])[0]
            out[rel_s[starts]] = np.add.reduceat(rows, starts, axis=0)
            return out[:, :r], out[:, r:]

        a_hh, a_ht = rows_accum2(hr, hn)  # Rh^T H, Rh^T T
        a_th, a_tt = rows_accum2(tr, tn)  # Rt^T H, Rt^T T
        rh_rh = rh.T @ rh
        rt_rt = rt.T @ rt
        rh_rt = rh.T @ rt
        d_c = np.stack([
            a_hh + a_hh.T - rh_rh,  # h2h: Rh^T H + H^T Rh - Rh^T Rh
            a_tt + a_tt.T - rt_rt,  # t2t
            a_ht + a_th.T - rh_rt,  # h2t: Rh^T T + H^T Rt - Rh^T Rt
            a_th + a_ht.T - rh_rt.T,  # t2h
        ])
        new_counts = self.base_counts - d_c[self.rel_type, self.rel_src, self.rel_dst]
        return (new_counts > 0.5).astype(np.float32)


def build_relation_graph(
    edge_index, edge_type, num_nodes, num_relations, device="cuda"
) -> Graph:
    """The relation graph (num_nodes = num_relations, 4 relation types)."""
    rei, ret = build_relation_graph_arrays(edge_index, edge_type, num_nodes, num_relations)
    return make_graph(
        rei, ret, num_nodes=num_relations, num_relations=4, device=device
    )
