"""The graph of relations, worked out again from a graph's edges.

ULTRA's relation graph (Galkin et al., ICLR 2024, section 4.1): two
relations are joined by meta-relation h2h (0) when some node is the head
of an edge of each, t2t (1) when it is the tail of an edge of each, h2t (2)
when it is the head of the first's edge and the tail of the second's, t2h
(3) the reverse. Here as products of incidence matrices: with H[v, r] = 1
where node v heads an edge of type r and T likewise for tails, the four
types are the nonzero entries of H^T H, T^T T, H^T T and T^T H, and entry
(i, j) is the edge of destination i and source j. The head of an edge is
the node of its first row in the edge list (``edge_index[0]``).
"""

from __future__ import annotations

import torch


def relation_graph(edge_index, edge_type, num_nodes: int, num_relations: int, device):
    """A graph dict (``reference/ultra.py``) of the relations' graph, its
    products counted in float64 on ``device``."""
    ei = torch.as_tensor(edge_index, device=device)
    et = torch.as_tensor(edge_type, device=device)
    inc = {}
    for role, nodes in (("h", ei[0]), ("t", ei[1])):
        m = torch.zeros(num_nodes, num_relations, dtype=torch.float64, device=device)
        m[nodes, et] = 1.0
        inc[role] = m
    dst, src, typ = [], [], []
    for t, (a, b) in enumerate((("h", "h"), ("t", "t"), ("h", "t"), ("t", "h"))):
        i, j = torch.nonzero(inc[a].T @ inc[b] > 0.5, as_tuple=True)
        dst.append(i)
        src.append(j)
        typ.append(torch.full_like(i, t))
    return {"dst": torch.cat(dst), "src": torch.cat(src), "etype": torch.cat(typ),
            "num_nodes": num_relations, "num_relations": 4}


def entity_graph(edge_index, edge_type, num_nodes: int, num_relations: int, device):
    """A graph dict of the given edges: messages go from ``edge_index[1]``
    into ``edge_index[0]``."""
    ei = torch.as_tensor(edge_index, device=device)
    return {"dst": ei[0].contiguous(), "src": ei[1].contiguous(),
            "etype": torch.as_tensor(edge_type, device=device),
            "num_nodes": num_nodes, "num_relations": num_relations}
