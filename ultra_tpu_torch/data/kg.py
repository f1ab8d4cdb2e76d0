"""Knowledge-graph splits and their device graphs.

Counterpart of ``ultra_tpu/data/kg.py``: the split and dataset records and
``split_to_graph``. The dataset loaders are ported with the command-line
slice (ROADMAP A6).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ultra_tpu_torch import tasks
from ultra_tpu_torch.graph import Graph, make_graph


class KGSplit(NamedTuple):
    edge_index: np.ndarray  # (2, E) message graph WITH inverses
    edge_type: np.ndarray  # (E,)
    num_nodes: int
    num_relations: int  # including inverses (2x raw)
    target_edge_index: np.ndarray  # (2, T) supervision edges, no inverses
    target_edge_type: np.ndarray  # (T,)


class KGDataset(NamedTuple):
    name: str
    train: KGSplit
    valid: KGSplit
    test: KGSplit


def split_to_graph(split: KGSplit, device="cuda") -> Graph:
    """KGSplit -> Graph with its relation graph attached; both CSRs are
    built here, once."""
    rel_graph = tasks.build_relation_graph(
        split.edge_index, split.edge_type, split.num_nodes, split.num_relations,
        device=device,
    )
    return make_graph(
        split.edge_index,
        split.edge_type,
        num_nodes=split.num_nodes,
        num_relations=split.num_relations,
        relation_graph=rel_graph,
        device=device,
    )
