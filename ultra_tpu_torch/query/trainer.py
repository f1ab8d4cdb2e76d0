"""UltraQuery's evaluation: the query graph on a device, the forward
functions and filtered complex-query evaluation.

Counterpart of the answering half of ``ultra_tpu/query/trainer.py``
(``prepare_query_graph``, ``answers_to_mask``, ``make_query_forward``,
``make_query_forward_grouped``, ``evaluate_queries``; the reference's
``run_query.py:157-264``). The training half (``query_bce_loss``, the train
step, ``train_queries``) is ROADMAP A10. Evaluation ranks each query's hard
answers among all nodes with its easy answers filtered (``query/metrics.py``)
and rolls the ranks into per-type, EPFO and negation metrics.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ultra_tpu_torch import tasks
from ultra_tpu_torch.graph import Graph, make_graph
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.query import metrics as qmetrics
from ultra_tpu_torch.query import ops
from ultra_tpu_torch.query.datasets import QueryDataset, QueryGraph
from ultra_tpu_torch.query.executor import (
    QueryConfig, execute, execute_grouped, projection_schedule,
)
from ultra_tpu_torch.train.eval import precompute_relation_representations


def prepare_query_graph(qg: QueryGraph, device="cuda") -> Graph:
    """A :class:`QueryGraph` on ``device``, with its relation graph
    (``tasks.build_relation_graph_arrays``) attached. A query graph already
    holds its inverse relations (``datasets_query.py:103-109``), so no
    inverse edges are added, and its ``edge_index`` is passed as the JAX
    package passes it: row 0 is the message destination in both packages.
    No edge is padded (the JAX package pads to a bucket of 2048 for its
    compiled programs; padding is weight 0 and changes no answer)."""
    rel_ei, rel_et = tasks.build_relation_graph_arrays(
        qg.edge_index, qg.edge_type, qg.num_nodes, qg.num_relations)
    rel_graph = make_graph(rel_ei, rel_et, num_nodes=qg.num_relations, num_relations=4,
                           device=device)
    return make_graph(qg.edge_index, qg.edge_type, num_nodes=qg.num_nodes,
                      num_relations=qg.num_relations, relation_graph=rel_graph, device=device)


def answers_to_mask(answers: Sequence[np.ndarray], num_nodes: int) -> np.ndarray:
    out = np.zeros((len(answers), num_nodes), dtype=bool)
    for i, a in enumerate(answers):
        if len(a):
            out[i, a] = True
    return out


def make_query_forward(model: Ultra, qcfg: QueryConfig):
    """``fwd(graph, kind, operand, rel_reprs_all=None)``: (B, V) logits of
    :func:`~ultra_tpu_torch.query.executor.execute`, without autograd;
    ``kind`` and ``operand`` as ``ops.decompose`` gives them (host arrays or
    tensors)."""

    @torch.no_grad()
    def fwd(graph: Graph, kind, operand, rel_reprs_all=None):
        return execute(model, qcfg, graph, torch.as_tensor(kind, device=graph.device),
                       torch.as_tensor(operand, device=graph.device),
                       rel_reprs_all=rel_reprs_all)

    return fwd


def make_query_forward_grouped(model: Ultra, qcfg: QueryConfig):
    """``fwd(graph, kind, operand, rel_reprs_all=None)``: (B, V) logits with
    the projections grouped into rounds (``execute_grouped``): as many
    passes a batch as its deepest query has projections (3 on BetaE's
    types), where :func:`make_query_forward` runs one at each slot where
    some query projects. The schedule is made on the host from ``kind``."""

    @torch.no_grad()
    def fwd(graph: Graph, kind, operand, rel_reprs_all=None):
        kind = np.asarray(kind)
        round_of, has_proj, arg_slot, n_rounds = projection_schedule(kind)
        on = lambda a: torch.as_tensor(a, device=graph.device)  # noqa: E731
        return execute_grouped(model, qcfg, graph, on(kind), on(np.asarray(operand)),
                               on(round_of), on(has_proj), on(arg_slot), n_rounds,
                               rel_reprs_all=rel_reprs_all)

    return fwd


def _process_group_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def evaluate_queries(
    model: Ultra,
    qcfg: QueryConfig,
    graph: Graph,
    dataset: QueryDataset,
    indices: np.ndarray,
    batch_size: int,
    metric_names: Sequence[str] = ("mrr", "hits@1", "hits@3", "hits@10", "mape"),
    restrict_nodes: Optional[np.ndarray] = None,
    distributed: Optional[bool] = None,
) -> Dict[str, float]:
    """Filtered complex-query evaluation of ``dataset``'s queries
    ``indices`` on ``graph`` (``run_query.py:157-264``), in batches of
    ``batch_size``; the last batch is padded by repeating its last query and
    the padded rows are dropped. The relation model runs once for all R
    relations (``precompute_relation_representations``).

    ``distributed`` (by default: when a process group of more than one
    process is initialised) would shard the queries over the processes, as
    the JAX package does: ROADMAP A12, so it raises for such a group."""
    if distributed is not False and _process_group_size() > 1:
        raise NotImplementedError("evaluate_queries over several processes is ROADMAP A12")
    model = model.eval()
    fwd = make_query_forward_grouped(model, qcfg)
    v = graph.num_nodes
    rel_reprs_all = precompute_relation_representations(model, graph)

    all_rank, all_answer_rank = [], []
    all_easy, all_hard, all_types, all_num_pred = [], [], [], []
    for start in range(0, len(indices), batch_size):
        take = indices[start : start + batch_size]
        valid = len(take)
        if valid < batch_size:
            take = np.concatenate([take, np.repeat(take[-1:], batch_size - valid)])
        kind, operand = ops.decompose(dataset.queries[take])
        pred = fwd(graph, kind, operand, rel_reprs_all).cpu().numpy()[:valid]
        take = take[:valid]
        easy = answers_to_mask([dataset.easy_answers[i] for i in take], v)
        hard = answers_to_mask([dataset.hard_answers[i] for i in take], v)
        rank, answer_rank, n_easy, n_hard = qmetrics.batch_evaluate(
            pred, easy, hard, restrict_nodes)
        prob = 1.0 / (1.0 + np.exp(-pred))
        num_pred = (prob * (prob > 0.5)).sum(axis=-1)
        all_rank.append(rank)
        all_answer_rank.append(answer_rank)
        all_easy.append(n_easy)
        all_hard.append(n_hard)
        all_types.append(dataset.types[take])
        all_num_pred.append(num_pred)

    vectors = [np.concatenate(x) for x in (all_rank, all_answer_rank, all_easy, all_hard,
                                            all_types, all_num_pred)]
    return qmetrics.evaluate(*vectors, metric_names, dataset.id2type)

