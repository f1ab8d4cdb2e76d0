"""Link-prediction evaluation: all-node scoring, filtered ranking, metrics.

Counterpart of ``ultra_tpu/train/eval.py``. The model scores every node as
the tail (and, through the inverse relation, as the head) of each test
triple on its device; the strict-negative masks are built on the host
(``tasks.strict_negative_mask``) and the metrics are aggregated there. The
JAX package's TPU launch amortisation (stream budgets, several batches per
dispatch) has no counterpart: a Python loop over batches takes its place,
pipelined one batch deep as the JAX package pipelines its groups.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ultra_tpu_torch import tasks
from ultra_tpu_torch.graph import Graph
from ultra_tpu_torch.models.nbfnet import (
    Ultra, entity_nbfnet_score_all, rel_nbfnet_apply, ultra_score_all,
)
from ultra_tpu_torch.utils import profiling


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


@torch.no_grad()
def score_and_rank_batch(model: Ultra, graph: Graph, batch, t_mask, h_mask):
    """batch (B, 3) positives; masks (B, V) bool. Returns (t_rank, h_rank):
    the tail direction, then the head direction through the inverse
    relation, each with its own relation-model pass."""
    h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
    num_direct = graph.num_relations // 2
    t_pred = ultra_score_all(model, graph, h, r_index=r)
    h_pred = ultra_score_all(model, graph, t, r_index=r + num_direct, query_r_index=r)
    return (tasks.compute_ranking(t_pred, t, t_mask),
            tasks.compute_ranking(h_pred, h, h_mask))


@torch.no_grad()
def score_and_rank_batch_cached(model: Ultra, graph: Graph, rel_reprs_all, batch,
                                t_mask, h_mask):
    """:func:`score_and_rank_batch` from precomputed (R, R, D) relation
    outputs. Both directions run as one entity-model pass over 2B queries:
    they share the graph, and the kernels get twice the feature width."""
    h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
    num_direct = graph.num_relations // 2
    rel_repr = rel_reprs_all[r]  # (B, R, D)
    both = entity_nbfnet_score_all(
        model.entity_model, graph, torch.cat([rel_repr, rel_repr]),
        torch.cat([h, t]), torch.cat([r, r + num_direct]),
    )  # (2B, V)
    b = batch.shape[0]
    return (tasks.compute_ranking(both[:b], t, t_mask),
            tasks.compute_ranking(both[b:], h, h_mask))


def evaluate(
    model: Ultra,
    graph: Graph,
    test_triples: np.ndarray,  # (N, 3) target edges (no inverses)
    filtered_index: tasks.GraphIndex,
    batch_size: int = 8,
    metrics: Iterable[str] = ("mr", "mrr", "hits@1", "hits@3", "hits@10"),
    limit: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    cache_relations: Optional[bool] = None,
) -> Dict[str, float]:
    """Filtered evaluation of both prediction directions of every triple;
    ``limit`` evaluates that many triples drawn without replacement."""
    trips = np.asarray(test_triples)
    if limit is not None and limit < len(trips):
        rng = rng or np.random.default_rng(0)
        trips = trips[rng.choice(len(trips), size=limit, replace=False)]
    return compute_metrics(
        metrics,
        *collect_rankings(model, graph, trips, filtered_index, batch_size=batch_size,
                          cache_relations=cache_relations),
    )


def collect_rankings(
    model: Ultra,
    graph: Graph,
    trips: np.ndarray,
    filtered_index: tasks.GraphIndex,
    batch_size: int = 8,
    cache_relations: Optional[bool] = None,
):
    """Filtered ranks and negative counts of a triple list: (ranking,
    num_negative, ranking_tail, num_negative_tail), host arrays; ranking
    holds each batch's tail ranks, then its head ranks.

    ``cache_relations`` (default: when the triples outnumber the
    precompute's passes) runs the relation model once for all R relations
    and both directions as one pass. The last batch is padded by repeating
    its last triple; the padded rows' results are dropped.

    The loop is a one-batch pipeline, as the JAX package's is: batch i+1's
    masks are built, uploaded and its pass enqueued before the host waits
    for batch i's ranks, so the host's work of a batch runs while the card
    computes the one before. On a card the masks go up from pinned memory
    without blocking, and each batch's ranks come back into pinned host
    tensors by a copy enqueued right after its ranking, behind a CUDA event
    that the host waits on before reading them (:func:`_enqueue_download`).

    Under a profiler the call records the span ``ultra.eval.collect_rankings``
    and in it ``ultra.eval.precompute`` and, for each batch, ``mask``,
    ``upload``, ``score`` (the pass, the ranking and the ranks' copy back
    enqueued), ``download`` (where the host waits on the device) and
    ``negatives``, each ``ultra.eval.<name>``: batch i's ``download`` and
    ``negatives`` follow batch i+1's ``score``. It counts the bytes it
    uploads to a card as ``h2d_bytes`` (``utils/profiling.py``).
    """
    with profiling.annotate("ultra.eval.collect_rankings"):
        model = model.eval()
        if cache_relations is None:
            cache_relations = len(trips) / batch_size > graph.num_relations / 64
        rel_reprs_all = None
        if cache_relations:
            with profiling.annotate("ultra.eval.precompute"):
                rel_reprs_all = precompute_relation_representations(model, graph)
        rankings, num_negatives, tail_rankings, num_tail_negs = [], [], [], []

        def collect(pending):
            ranks, done, t_mask, h_mask, valid = pending
            with profiling.annotate("ultra.eval.download"):
                if done is not None:
                    done.synchronize()
                t_rank, h_rank = (r.numpy()[:valid] for r in ranks)
            with profiling.annotate("ultra.eval.negatives"):
                t_neg, h_neg = _count_rows(t_mask[:valid]), _count_rows(h_mask[:valid])
            rankings.extend((t_rank, h_rank))
            num_negatives.extend((t_neg, h_neg))
            tail_rankings.append(t_rank)
            num_tail_negs.append(t_neg)

        pending = None
        for start in range(0, len(trips), batch_size):
            batch = trips[start:start + batch_size]
            valid = len(batch)
            if valid < batch_size:
                batch = np.concatenate([batch, np.repeat(batch[-1:], batch_size - valid, axis=0)])
            with profiling.annotate("ultra.eval.mask"):
                t_mask, h_mask = tasks.strict_negative_mask(filtered_index, batch)
            with profiling.annotate("ultra.eval.upload"):
                args = _upload((batch, t_mask, h_mask), graph.device)
            with profiling.annotate("ultra.eval.score"):
                if rel_reprs_all is None:
                    ranks = score_and_rank_batch(model, graph, *args)
                else:
                    ranks = score_and_rank_batch_cached(model, graph, rel_reprs_all, *args)
                ranks, done = _enqueue_download(ranks)
            if pending is not None:
                collect(pending)
            pending = (ranks, done, t_mask, h_mask, valid)
        if pending is not None:
            collect(pending)
        return (np.concatenate(rankings), np.concatenate(num_negatives),
                np.concatenate(tail_rankings), np.concatenate(num_tail_negs))


def _count_rows(mask: np.ndarray) -> np.ndarray:
    """(B,) int64 count of each row's True entries. ``count_nonzero`` of a
    whole row counts its bytes directly, where a sum (or ``count_nonzero``)
    over an axis widens each to int64 first, several times slower."""
    return np.array([np.count_nonzero(row) for row in mask], dtype=np.int64)


def _upload(arrays, device: torch.device):
    """Host arrays as tensors on ``device``. To a card each goes up from a
    pinned buffer without blocking the host, and its bytes count as
    ``h2d_bytes``; PyTorch's caching host allocator keeps a pinned block
    until its copy has run. numpy fills the buffer in one thread: a host
    ``copy_`` (as in ``pin_memory()``) wakes PyTorch's intra-op threads,
    whose stragglers on a busy host held the card idle for milliseconds."""
    if device.type != "cuda":
        return [torch.as_tensor(a, device=device) for a in arrays]
    profiling.count("h2d_bytes", sum(a.nbytes for a in arrays))
    out = []
    for a in arrays:
        pinned = torch.empty(a.shape, dtype=torch.as_tensor(a).dtype, pin_memory=True)
        pinned.numpy()[...] = a
        out.append(pinned.to(device, non_blocking=True))
    return out


def _enqueue_download(tensors):
    """(host tensors, event): on a card, copies of ``tensors`` enqueued into
    fresh pinned host tensors, and an event recorded behind them; the host
    reads the copies after ``event.synchronize()``. Elsewhere the tensors
    themselves and no event."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in tensors]
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))
    return host, done


def compute_metrics(metrics, ranking, num_negative, ranking_t=None, num_negative_t=None):
    """mr, mrr, hits@k, the unbiased hits@k_n estimate, and each of them on
    the tail direction alone as ``<metric>-tail``."""
    out = {}
    for metric in metrics:
        if metric.endswith("-tail"):
            name, _rank, _neg = metric[: -len("-tail")], ranking_t, num_negative_t
        else:
            name, _rank, _neg = metric, ranking, num_negative
        _rank = _rank.astype(np.float64)
        if name == "mr":
            score = _rank.mean()
        elif name == "mrr":
            score = (1.0 / _rank).mean()
        elif name.startswith("hits@"):
            values = name[5:].split("_")
            threshold = int(values[0])
            if len(values) > 1:
                num_sample = int(values[1])
                # P(at most threshold-1 false positives among num_sample-1 draws)
                fp_rate = (_rank - 1) / _neg
                score = 0.0
                for i in range(threshold):
                    num_comb = (math.factorial(num_sample - 1) / math.factorial(i)
                                / math.factorial(num_sample - i - 1))
                    score = score + num_comb * (fp_rate**i) * (1 - fp_rate) ** (
                        num_sample - i - 1)
                score = float(np.mean(score))
            else:
                score = float((_rank <= threshold).mean())
        else:
            raise ValueError(f"unknown metric {name!r}")
        out[metric] = float(score)
    return out
