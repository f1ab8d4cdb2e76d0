"""UltraQuery's training and evaluation: the query graph on a device, the
loss, the train steps, the training loop, the forward functions and
filtered complex-query evaluation.

Counterpart of ``ultra_tpu/query/trainer.py`` (the reference's
``run_query.py:53-264``). Training draws a batch of queries, plans its
traversal dropout on the host (``query/executor.py::simulate_symbolic``,
or ``simulate_symbolic_grouped`` with ``train.grouped_projections``) and
takes a step on the per-slot (or per-round) graphs; the loss is BCE over all
nodes against the easy answers, positives weighted 1/num_positive a query,
negatives by a self-adversarial softmax (``run_query.py:96-113``).
Evaluation ranks each query's hard answers among all nodes with its easy
answers filtered, on the device (``rank_queries``, ``query/metrics.py``),
and rolls the ranks into per-type, EPFO and negation metrics on the host.
In a process group (``parallel/multihost.py``), ``train.data_parallel``
shards each batch's queries over the ranks and averages the gradients (the
JAX package shards them over one process's devices), and evaluation shards
the queries and gathers the results. The JAX package's log of XLA compile
variants has no counterpart.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ultra_tpu_torch import tasks
from ultra_tpu_torch.graph import Graph, make_graph
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.parallel import multihost
from ultra_tpu_torch.parallel.dp import grad_sync
from ultra_tpu_torch.parallel.mesh import make_mesh
from ultra_tpu_torch.query import metrics as qmetrics
from ultra_tpu_torch.query import ops
from ultra_tpu_torch.query.datasets import QueryDataset, QueryGraph
from ultra_tpu_torch.query.executor import (
    DropoutPlanner, QueryConfig, cheap_schedule, execute, execute_grouped, graphs_for_slots,
    projection_schedule, simulate_symbolic, simulate_symbolic_grouped,
)
from ultra_tpu_torch.train.eval import precompute_relation_representations
from ultra_tpu_torch.train.loop import TrainState, init_train_state
from ultra_tpu_torch.utils import ckpt as ckpt_lib
from ultra_tpu_torch.utils import profiling

logger = logging.getLogger("ultra_tpu_torch")


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


def graph_host(qg: QueryGraph, graph: Graph) -> dict:
    """The host arrays the symbolic machine reads of the query graph ``qg``,
    whose device graph is ``graph``."""
    return {"edge_index": qg.edge_index, "edge_type": qg.edge_type,
            "num_nodes": qg.num_nodes, "num_relations": qg.num_relations,
            "e_pad": graph.num_edges_padded, "inverse_rel_plus_one": qg.inverse_rel_plus_one}


def dropout_planner(host: dict, graph: Graph) -> DropoutPlanner:
    """The :class:`DropoutPlanner` of the base graph ``graph`` (its host
    arrays ``host``). Its relation-graph masks are read by edge position, so
    the masker's relation edges must be ``graph.relation_graph``'s, in its
    order: both come from ``tasks.build_relation_graph_arrays``, and this
    holds them equal."""
    planner = DropoutPlanner(host)
    rel, masker = graph.relation_graph, planner.masker
    m = masker.num_rel_edges
    assert m <= rel.num_edges_padded and not rel.edge_weight[m:].any()
    assert np.array_equal(rel.edge_index[:, :m].cpu().numpy(),
                          np.stack([masker.rel_src, masker.rel_dst]))
    assert np.array_equal(rel.edge_type[:m].cpu().numpy(), masker.rel_type)
    return planner


def query_bce_loss(pred, target, adversarial_temperature: float):
    """pred (B, V) logits, target (B, V) in {0, 1} (the easy answers): BCE
    with positives weighted 1/num_positive and negatives by a softmax over
    the row's negative logits at ``adversarial_temperature`` (no gradient
    through the weights), or uniformly at 0 (``run_query.py:96-113``)."""
    loss = F.binary_cross_entropy_with_logits(pred, target, reduction="none")
    is_pos = target > 0.5
    is_neg = ~is_pos
    num_pos = is_pos.sum(dim=-1, keepdim=True).clamp_min(1)
    pos_w = torch.where(is_pos, 1.0 / num_pos, 0.0)
    if adversarial_temperature > 0:
        logits = torch.where(is_neg, pred.detach() / adversarial_temperature, -torch.inf)
        neg_w = torch.where(is_neg, torch.softmax(logits, dim=-1), 0.0)
    else:
        num_neg = is_neg.sum(dim=-1, keepdim=True).clamp_min(1)
        neg_w = torch.where(is_neg, 1.0 / num_neg, 0.0)
    weight = pos_w + neg_w
    return ((loss * weight).sum(dim=-1) / weight.sum(dim=-1)).mean()


def make_query_train_step(qcfg: QueryConfig, adversarial_temperature: float = 1.0,
                          sync_grads=None):
    """``step(state, slot_graphs, kind, operand, target) -> loss``: one
    update through :func:`execute` on the per-slot graphs
    (:func:`~ultra_tpu_torch.query.executor.graphs_for_slots`); ``kind``,
    ``operand`` (``ops.decompose``) and ``target`` (B, V) f32 host arrays.
    The loss is a 0-d tensor on the device; the gradients stay in
    ``.grad``. ``sync_grads`` as in ``train/loop.py::make_train_step``."""

    def step(state: TrainState, slot_graphs, kind, operand, target):
        device = slot_graphs[0].device
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        pred = execute(model, qcfg, list(slot_graphs), on(kind), on(operand))
        loss = query_bce_loss(pred, on(target), adversarial_temperature)
        loss.backward()
        loss = loss.detach()
        if sync_grads is not None:
            loss = sync_grads(model, loss)
        state.optimizer.step()
        state.step += 1
        return loss

    return step


def make_grouped_query_train_step(qcfg: QueryConfig, adversarial_temperature: float = 1.0,
                                  grad_accum: int = 1, sync_grads=None):
    """``step(state, round_graphs, kind, operand, target) -> loss``: one
    update through :func:`execute_grouped`, the projections grouped into
    rounds (``train.grouped_projections``), one graph a round
    (``simulate_symbolic_grouped``). Host arrays as for
    :func:`make_query_train_step`; the schedule is made here from ``kind``.

    ``grad_accum`` > 1 runs ``gcd(B, grad_accum)`` equal micro-batches of
    consecutive queries one after another on the same round graphs and
    averages their gradients before the one update: the full batch's step,
    in less memory (the loss is a mean over queries). A micro-batch runs the
    rounds its own deepest query needs. ``sync_grads`` as in
    ``train/loop.py::make_train_step``."""

    def step(state: TrainState, round_graphs, kind, operand, target):
        device = round_graphs[0].device
        model = state.model.train()
        kind, operand, target = np.asarray(kind), np.asarray(operand), np.asarray(target)
        accum = math.gcd(kind.shape[0], grad_accum)
        state.optimizer.zero_grad(set_to_none=True)
        on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        loss = 0.0
        for rows in np.split(np.arange(kind.shape[0]), accum):
            round_of, has_proj, arg_slot, n_rounds = projection_schedule(kind[rows])
            pred = execute_grouped(model, qcfg, list(round_graphs[:n_rounds]), on(kind[rows]),
                                   on(operand[rows]), on(round_of), on(has_proj),
                                   on(arg_slot), n_rounds,
                                   cheap=cheap_schedule(kind[rows], round_of, n_rounds))
            micro = query_bce_loss(pred, on(target[rows]), adversarial_temperature)
            (micro / accum).backward()
            loss = loss + micro.detach()
        loss = loss / accum
        if sync_grads is not None:
            loss = sync_grads(model, loss)
        state.optimizer.step()
        state.step += 1
        return loss

    return step


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
    some query projects. The schedules (of the projections and of the cheap
    ops, ``cheap_schedule``) are made on the host from ``kind``, and the
    program goes to the device with them in one copy (:func:`_upload`).

    Under a profiler ``fwd`` records the span ``ultra.query.schedule``
    (the schedules and the upload) and counts ``query_passes``
    (projection passes run) and ``query_projections`` (queries that
    project in a pass) (``utils/profiling.py``)."""

    @torch.no_grad()
    def fwd(graph: Graph, kind, operand, rel_reprs_all=None):
        with profiling.annotate("ultra.query.schedule"):
            kind = np.asarray(kind)
            round_of, has_proj, arg_slot, n_rounds = projection_schedule(kind)
            cheap = cheap_schedule(kind, round_of, n_rounds)
            kind_t, operand_t, round_of_t, has_proj_t, arg_slot_t = _upload(
                (kind, operand, round_of, has_proj, arg_slot), graph.device)
            profiling.count("query_passes", n_rounds)
            profiling.count("query_projections", int(has_proj.sum()))
        return execute_grouped(model, qcfg, graph, kind_t, operand_t, round_of_t,
                               has_proj_t.bool(), arg_slot_t, n_rounds,
                               rel_reprs_all=rel_reprs_all, cheap=cheap)

    return fwd


def _upload(arrays, device: torch.device):
    """Host integer arrays on ``device`` as int64 tensors of their shapes,
    in one copy. To a card that is an asynchronous copy from pinned memory,
    so the host goes on enqueueing while the card runs the work before;
    under a profiler its bytes count as ``h2d_bytes``."""
    arrays = [np.asarray(a) for a in arrays]
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]).astype(np.int64))
    if device.type == "cuda":
        profiling.count("h2d_bytes", flat.nbytes)
        flat = flat.pin_memory().to(device, non_blocking=True)
    return [p.view(a.shape) for p, a in zip(torch.split(flat, [a.size for a in arrays]), arrays)]


@torch.no_grad()
def rank_queries(
    model: Ultra,
    qcfg: QueryConfig,
    graph: Graph,
    dataset: QueryDataset,
    indices: np.ndarray,
    batch_size: int,
    restrict_nodes: Optional[np.ndarray] = None,
    rel_reprs_all=None,
):
    """The per-query vectors of the filtered evaluation of ``dataset``'s
    queries ``indices`` on ``graph``, host arrays in the order
    ``qmetrics.evaluate`` takes them: (hard answers' filtered ranks,
    answers' unfiltered ranks (easy block, then hard block, a query),
    num_easy, num_hard, types, num_pred (float64)).

    Batches of ``batch_size`` run through :func:`make_query_forward_grouped`;
    the last is padded by repeating its last query and the padded rows are
    dropped. Each batch's answer lists go to the device in one copy, and
    the ranking runs there (``qmetrics.batch_evaluate_device``,
    ``qmetrics.predicted_size``); nothing waits for the device until the
    vectors of every batch come back together. ``rel_reprs_all``: the
    relation model's outputs for every relation
    (``precompute_relation_representations``), computed here when not
    given.

    Under a profiler the call records the span ``ultra.query.rank_queries``
    and in it ``ultra.query.precompute`` (where it computes
    ``rel_reprs_all``), for each batch ``ultra.query.schedule`` (decompose
    and the answer lists' upload) and the forward's spans and counts, and
    ``ultra.query.metrics`` (the ranking enqueued), and at the end
    ``ultra.query.download`` (``utils/profiling.py``)."""
    with profiling.annotate("ultra.query.rank_queries"):
        model = model.eval()
        device = graph.device
        fwd = make_query_forward_grouped(model, qcfg)
        if rel_reprs_all is None:
            with profiling.annotate("ultra.query.precompute"):
                rel_reprs_all = precompute_relation_representations(model, graph)
        keep = None
        if restrict_nodes is not None:
            keep = torch.zeros(graph.num_nodes, dtype=torch.bool, device=device)
            keep[torch.as_tensor(np.asarray(restrict_nodes), device=device)] = True
        indices = np.asarray(indices)
        out = []
        for start in range(0, len(indices), batch_size):
            take = indices[start : start + batch_size]
            valid = len(take)
            if valid < batch_size:
                take = np.concatenate([take, np.repeat(take[-1:], batch_size - valid)])
            with profiling.annotate("ultra.query.schedule"):
                kind, operand = ops.decompose(dataset.queries[take])
                answers, sizes = qmetrics.pack_answers(
                    [dataset.easy_answers[i] for i in take[:valid]],
                    [dataset.hard_answers[i] for i in take[:valid]])
                (answers,) = _upload((answers,), device)
            logits = fwd(graph, kind, operand, rel_reprs_all)[:valid]
            with profiling.annotate("ultra.query.metrics"):
                ranks = qmetrics.batch_evaluate_device(
                    logits, qmetrics.PackedAnswers.split(answers, sizes), keep)
                out.append((*ranks, qmetrics.predicted_size(logits)))
        with profiling.annotate("ultra.query.download"):
            ints = [torch.cat([batch[k] for batch in out]) for k in range(4)]
            flat = torch.cat(ints).cpu().numpy()
            num_pred = torch.cat([batch[4] for batch in out]).cpu().numpy()
        hard_rank, answer_rank, num_easy, num_hard = np.split(
            flat, np.cumsum([len(x) for x in ints])[:-1])
        return (hard_rank, answer_rank, num_easy, num_hard, dataset.types[indices], num_pred)


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
    ``batch_size`` (:func:`rank_queries`). The relation model runs once for
    all R relations (``precompute_relation_representations``).

    ``distributed`` (by default: in a process group of more than one
    process) shards ``indices`` over the ranks (``shard_indices`` without
    shuffling, so a few queries count twice when the ranks do not divide
    them) and gathers the per-query results on every rank, which returns the
    whole metric dict: the reference's ``gather_results``
    (``query_utils.py:238-282``)."""
    distributed = multihost.process_count() > 1 and distributed is not False
    if distributed:
        indices = np.asarray(indices)[
            multihost.shard_indices(len(indices), epoch=0, shuffle=False)]
    model = model.eval()
    rel_reprs_all = precompute_relation_representations(model, graph)
    vectors = rank_queries(model, qcfg, graph, dataset, indices, batch_size,
                           restrict_nodes=restrict_nodes, rel_reprs_all=rel_reprs_all)
    if distributed:
        vectors = [multihost.gather_ranks(x) for x in vectors]
    return qmetrics.evaluate(*vectors, metric_names, dataset.id2type)


def make_step(cfg: dict, qcfg: QueryConfig, grouped: bool, sync_grads=None):
    """The train step ``cfg`` asks for: grouped (with ``train.grad_accum``)
    or per slot."""
    adv_temp = float(cfg["task"].get("adversarial_temperature", 0.2))
    if grouped:
        return make_grouped_query_train_step(
            qcfg, adv_temp, grad_accum=int(cfg["train"].get("grad_accum", 1)),
            sync_grads=sync_grads)
    return make_query_train_step(qcfg, adv_temp, sync_grads=sync_grads)


def plan_and_step(step_fn, state, grouped, base_graph, host, planner, qcfg, rng, kind,
                  operand, target, rows=slice(None)):
    """Plan one batch's traversal dropout on the host from ``rng``, as the
    JAX loop draws it, put its masks on the device and take the step on the
    batch's ``rows`` (a data rank's; the plan is the whole batch's)."""
    if grouped:
        round_of, has_proj, arg_slot, n_rounds = projection_schedule(kind)
        plan = simulate_symbolic_grouped(kind, operand, round_of, has_proj, arg_slot, n_rounds,
                                         host, qcfg, rng, planner)
    else:
        plan = simulate_symbolic(kind, operand, host, qcfg, rng, training=True,
                                 planner=planner)
    return step_fn(state, graphs_for_slots(base_graph, plan), kind[rows], operand[rows],
                   target[rows])


def train_queries(cfg: dict, model: Ultra, qcfg: QueryConfig, dataset: QueryDataset,
                  workdir: str, seed: int = 1024) -> Ultra:
    """Train ``model`` on ``dataset``'s training queries as ``cfg`` says
    (``run_query.py:53-155``) and return it with the best validation
    checkpoint's weights.

    ``cfg`` has the YAML's sections: ``train`` (``num_epoch``,
    ``batch_size``, ``batch_per_epoch``, ``grouped_projections``,
    ``grad_accum``, ``fast_test``), ``task`` (``adversarial_temperature``),
    ``optimizer`` (``lr``) and ``resume_from``. The graphs go on the model's
    device. Each epoch ends with ``workdir/model_latest.pth``; without
    ``resume_from``, ``$ULTRA_RESUME_FROM`` names a checkpoint to resume
    from when that file exists.

    ``train.data_parallel: yes`` shards each batch's queries over the ranks
    of the process group (contiguous rows, ``batch_size`` a multiple of the
    ranks): every rank draws the same batch and the same dropout plan from
    the same generator, steps on its rows, and the gradients are averaged
    (``parallel/dp.py``), so the numbers equal one process's. With
    ``task.per_rank_traversal_dropout`` (the reference's DDP, whose ranks
    draw their own dropout) rank s plans its rows from ``default_rng(seed +
    s)``, per slot. Without a process group the ranks are this one."""
    train_cfg, task_cfg = cfg["train"], cfg["task"]
    num_epoch = int(train_cfg.get("num_epoch", 0))
    if num_epoch == 0:
        return model
    data_parallel = bool(train_cfg.get("data_parallel", False))
    per_rank = bool(task_cfg.get("per_rank_traversal_dropout", False))
    if per_rank and not data_parallel:
        raise ValueError("task.per_rank_traversal_dropout requires train.data_parallel")
    batch_size = int(train_cfg.get("batch_size", 8))
    batch_per_epoch = train_cfg.get("batch_per_epoch") or None
    fast_test = train_cfg.get("fast_test")
    grouped = bool(train_cfg.get("grouped_projections", False)) and not per_rank
    device = next(model.parameters()).device
    mesh = make_mesh() if data_parallel else None
    rows = mesh.rows(batch_size) if data_parallel else slice(None)

    qg_train = dataset.graphs[0]
    base_graph = prepare_query_graph(qg_train, device=device)
    host = graph_host(qg_train, base_graph)
    valid_graph = prepare_query_graph(dataset.graphs[1], device=device)
    planner = dropout_planner(host, base_graph)

    state = init_train_state(model, lr=float(cfg["optimizer"].get("lr", 5e-4)))
    ckpt_lib.resume(cfg, state, "query train")
    step_fn = make_step(cfg, qcfg, grouped, grad_sync(mesh) if data_parallel else None)

    (tr_lo, tr_hi), (va_lo, va_hi), _ = dataset.split_ranges()
    train_idx = np.arange(tr_lo, tr_hi)
    valid_idx = np.arange(va_lo, va_hi)
    rng = np.random.default_rng(seed)
    # per-rank dropout: the rank-coupled stream of run.py:234's seeding
    rank_rng = np.random.default_rng(seed + mesh.data_index) if per_rank else None
    tracker = ckpt_lib.BestModelTracker(workdir)
    steps_per_epoch = batch_per_epoch or math.ceil(len(train_idx) / batch_size)
    epoch_block = math.ceil(num_epoch / 10)
    v = base_graph.num_nodes

    epoch = 0
    for block_start in range(0, num_epoch, epoch_block):
        for epoch in range(block_start, min(num_epoch, block_start + epoch_block)):
            t0 = time.time()
            losses = []
            perm = rng.permutation(train_idx)
            for step in range(steps_per_epoch):
                take = perm[(step * batch_size) % len(perm):][:batch_size]
                while len(take) < batch_size:  # wrap (tiny datasets: repeat)
                    take = np.concatenate([take, perm[: batch_size - len(take)]])
                kind, operand = ops.decompose(dataset.queries[take])
                target = answers_to_mask([dataset.easy_answers[i] for i in take],
                                         v).astype(np.float32)
                if per_rank:
                    kind, operand, target = kind[rows], operand[rows], target[rows]
                    plan = simulate_symbolic(kind, operand, host, qcfg, rank_rng, training=True,
                                             planner=planner)
                    losses.append(step_fn(state, graphs_for_slots(base_graph, plan), kind,
                                          operand, target))
                    continue
                losses.append(plan_and_step(step_fn, state, grouped, base_graph, host, planner,
                                            qcfg, rng, kind, operand, target, rows))
            logger.warning("epoch %d: avg bce %.6f (%.1fs)", epoch,
                           float(torch.stack(losses).mean()), time.time() - t0)
            ckpt_lib.save_train_state(os.path.join(workdir, "model_latest.pth"), state)

        idx = valid_idx
        if fast_test is not None and fast_test < len(idx):
            idx = np.random.default_rng(1024).choice(idx, size=fast_test, replace=False)
        val = evaluate_queries(state.model, qcfg, valid_graph, dataset, idx,
                               batch_size=batch_size, metric_names=("mrr",),
                               restrict_nodes=dataset.graphs[1].restrict_nodes)
        logger.warning("valid after epoch %d: mrr %.4f", epoch, val["mrr"])
        tracker.update(epoch + 1, val["mrr"], state)

    return tracker.load_best(state.model)
