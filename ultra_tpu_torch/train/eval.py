"""Evaluation helpers.

Counterpart of ``ultra_tpu/train/eval.py`` (the part serving needs);
filtered evaluation is ROADMAP A5.
"""

from __future__ import annotations

import torch

from ultra_tpu_torch.graph import Graph
from ultra_tpu_torch.models.nbfnet import Ultra, rel_nbfnet_apply


@torch.no_grad()
def precompute_relation_representations(model: Ultra, graph: Graph, chunk: int = 64):
    """(R, R, D) relation-graph outputs for every query relation.

    The relation model depends only on the query relation id, so it runs
    once per relation instead of once per request. Chunks of ``chunk``
    relations bound memory; the last chunk wraps around (ids modulo R), so
    every chunk has the same shape.
    """
    r_total = graph.num_relations
    outs = []
    for start in range(0, r_total, chunk):
        rels = torch.arange(start, start + chunk, device=graph.device) % r_total
        outs.append(rel_nbfnet_apply(model.relation_model, graph.relation_graph, rels))
    return torch.cat(outs, dim=0)[:r_total]
