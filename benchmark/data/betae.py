"""BetaE's 14 query types sampled from a graph, and the request stream of
the serving cells.

A frozen copy of the port's sampler (``ultra_tpu_torch/data/
synthetic_queries.py``: ``TYPE2STRUCT``, ``_Adj``, ``_evaluate``,
``_chain_backward``, ``_sample_instance``, ``_sample_instance_from_target``
and the selection loop of ``write_betae_dataset``'s ``gen_split`` for
training queries). The adjacency finds a node's edges through a CSR where
the original scans every edge; both list them in the same order, so one
``rng`` draws the same queries (``tests/test_bench_copies.py``).

Relations follow BetaE: direct relation r is id 2r, its inverse 2r + 1, and
the graph holds both directions of every triple.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# the BetaE nested-tuple structures
TYPE2STRUCT = {
    "1p": ("e", ("r",)),
    "2p": ("e", ("r", "r")),
    "3p": ("e", ("r", "r", "r")),
    "2i": (("e", ("r",)), ("e", ("r",))),
    "3i": (("e", ("r",)), ("e", ("r",)), ("e", ("r",))),
    "ip": ((("e", ("r",)), ("e", ("r",))), ("r",)),
    "pi": (("e", ("r", "r")), ("e", ("r",))),
    "2in": (("e", ("r",)), ("e", ("r", "n"))),
    "3in": (("e", ("r",)), ("e", ("r",)), ("e", ("r", "n"))),
    "inp": ((("e", ("r",)), ("e", ("r", "n"))), ("r",)),
    "pin": (("e", ("r", "r")), ("e", ("r", "n"))),
    "pni": (("e", ("r", "r", "n")), ("e", ("r",))),
    "2u-DNF": (("e", ("r",)), ("e", ("r",)), ("u",)),
    "up-DNF": ((("e", ("r",)), ("e", ("r",)), ("u",)), ("r",)),
}


def betae_edges(triples: np.ndarray):
    """(h, r, t) int arrays of both directions of (T, 3) (h, t, r) triples
    with BetaE's ids: (h, 2r, t), then (t, 2r + 1, h)."""
    h, t, r = triples[:, 0], triples[:, 1], triples[:, 2]
    return (np.concatenate([h, t]), np.concatenate([2 * r, 2 * r + 1]),
            np.concatenate([t, h]))


class Adj:
    """Per-relation CSR over (h, r, t) int triples (relations include
    inverses): forward traversal, and a node's outgoing and incoming edges
    in the order of the relation-sorted edge list."""

    def __init__(self, h, r, t, num_nodes, num_relations):
        self.v = num_nodes
        order = np.lexsort((h, r))
        self.h, self.r, self.t = h[order], r[order], t[order]
        self.r_start = np.searchsorted(self.r, np.arange(num_relations))
        self.r_end = np.searchsorted(self.r, np.arange(num_relations), "right")
        self.by_h, self.h_ptr = self._by_node(self.h)
        self.by_t, self.t_ptr = self._by_node(self.t)

    def _by_node(self, nodes):
        """Edge positions grouped by node, ascending within a node."""
        order = np.argsort(nodes, kind="stable")
        ptr = np.zeros(self.v + 1, dtype=np.int64)
        ptr[1:] = np.cumsum(np.bincount(nodes, minlength=self.v))
        return order, ptr

    def traverse(self, mask: np.ndarray, rel: int) -> np.ndarray:
        lo, hi = self.r_start[rel], self.r_end[rel]
        sel = mask[self.h[lo:hi]]
        out = np.zeros(self.v, dtype=bool)
        out[self.t[lo:hi][sel]] = True
        return out

    def rels_from(self, node: int, rng) -> Optional[Tuple[int, int]]:
        """A uniformly random outgoing (rel, tail) of ``node``."""
        idx = self.by_h[self.h_ptr[node]:self.h_ptr[node + 1]]
        if idx.size == 0:
            return None
        e = idx[rng.integers(idx.size)]
        return int(self.r[e]), int(self.t[e])

    def rels_into(self, node: int, rng) -> Optional[Tuple[int, int]]:
        """A uniformly random incoming (rel, head) of ``node``."""
        idx = self.by_t[self.t_ptr[node]:self.t_ptr[node + 1]]
        if idx.size == 0:
            return None
        e = idx[rng.integers(idx.size)]
        return int(self.r[e]), int(self.h[e])


def evaluate(instance, struct, adj: Adj) -> np.ndarray:
    """Boolean answer vector of a BetaE instance on ``adj``."""
    if struct[0] == "e":  # anchored chain
        anchor, rels = instance
        mask = np.zeros(adj.v, dtype=bool)
        mask[anchor] = True
        for r in rels:
            mask = ~mask if r == -2 else adj.traverse(mask, r)
        return mask
    if struct[-1] == ("r",) or struct[-1] == ("n", "r"):
        mask = evaluate(instance[0], struct[0], adj)
        for tok in instance[1]:
            mask = ~mask if tok == -2 else adj.traverse(mask, tok)
        return mask
    if struct[-1] == ("u",):
        out = np.zeros(adj.v, dtype=bool)
        for inst_b, struct_b in zip(instance[:-1], struct[:-1]):
            out |= evaluate(inst_b, struct_b, adj)
        return out
    out = np.ones(adj.v, dtype=bool)
    for inst_b, struct_b in zip(instance, struct):
        out &= evaluate(inst_b, struct_b, adj)
    return out


def _chain_backward(target: int, length: int, adj: Adj, rng, negate=False):
    """An ('e', rels) chain instance reaching ``target``, or None where the
    walk dead-ends; a negated chain walks forward from a random anchor."""
    if negate:
        for _ in range(8):
            anchor = int(rng.integers(adj.v))
            rels = []
            node = anchor
            ok = True
            for _ in range(length):
                step = adj.rels_from(node, rng)
                if step is None:
                    ok = False
                    break
                rels.append(step[0])
                node = step[1]
            if ok:
                return (anchor, tuple(rels) + (-2,))
        return None
    node = target
    rels = []
    for _ in range(length):
        step = adj.rels_into(node, rng)
        if step is None:
            return None
        rels.append(step[0])
        node = step[1]
    return (node, tuple(reversed(rels)))


def _sample_instance(qtype: str, adj: Adj, rng):
    """One instance of ``qtype`` on ``adj``, or None on a failed attempt."""
    struct = TYPE2STRUCT[qtype]
    target = int(rng.integers(adj.v))
    if struct[0] == "e":
        return _chain_backward(target, len([x for x in struct[1] if x == "r"]), adj, rng)
    if struct[-1] == ("r",):
        step = adj.rels_into(target, rng)
        if step is None:
            return None
        last_rel, mid = step
        inner = _sample_instance_from_target(struct[0], mid, adj, rng)
        if inner is None:
            return None
        return (inner, (last_rel,))
    return _sample_instance_from_target(struct, target, adj, rng)


def _sample_instance_from_target(struct, target: int, adj: Adj, rng):
    """An intersection or union instance whose positive branches reach
    ``target``."""
    if struct[0] == "e":
        length = len([x for x in struct[1] if x == "r"])
        return _chain_backward(target, length, adj, rng, negate=struct[1][-1] == "n")
    if struct[-1] == ("u",):
        insts = []
        for i, sb in enumerate(struct[:-1]):
            length = len([x for x in sb[1] if x == "r"])
            anchor = target if i == 0 else int(rng.integers(adj.v))
            inst = _chain_backward(anchor, length, adj, rng)
            if inst is None:
                return None
            insts.append(inst)
        return tuple(insts) + ((-1,),)
    insts = []
    for sb in struct:
        length = len([x for x in sb[1] if x == "r"])
        inst = _chain_backward(target, length, adj, rng, negate=sb[1][-1] == "n")
        if inst is None:
            return None
        insts.append(inst)
    return tuple(insts)


def sample_queries(adj: Adj, types, per_type: int, rng) -> Dict[str, List]:
    """Up to ``per_type`` distinct instances of each type, in the order they
    were drawn, each with a non-empty answer set on ``adj`` (``gen_split``'s
    loop for training queries, at most 60 attempts an instance)."""
    out = {}
    for qt in types:
        struct = TYPE2STRUCT[qt]
        got, seen, tries = [], set(), 0
        while len(got) < per_type and tries < per_type * 60:
            tries += 1
            inst = _sample_instance(qt, adj, rng)
            if inst is None or inst in seen:
                continue
            if not evaluate(inst, struct, adj).any():
                continue
            seen.add(inst)
            got.append(inst)
        out[qt] = got
    return out


def relabel_instance(inst, ent: np.ndarray, rel: np.ndarray):
    """A nested instance with entity ids through ``ent`` and BetaE relation
    ids through ``rel`` (a permutation of the ids, inverses kept paired)."""
    if len(inst) == 2 and isinstance(inst[-1][-1], int):  # (var, unary ops)
        var, unary = inst
        var = int(ent[var]) if isinstance(var, int) else relabel_instance(var, ent, rel)
        return (var, tuple(-2 if u == -2 else int(rel[u]) for u in unary))
    return tuple(b if b == (-1,) else relabel_instance(b, ent, rel) for b in inst)


def to_lists(inst):
    """A nested tuple as the nested JSON lists a client sends."""
    return [to_lists(x) for x in inst] if isinstance(inst, tuple) else inst
