"""Multi-process training and evaluation for link prediction.

Counterpart of ``ultra_tpu/train/distributed.py`` (the reference's
``torch.distributed.launch`` + DDP + ``DistributedSampler``,
``run.py:32-46``, ``util.py:84-141``):

- every process joins the group (``parallel/multihost.py::initialize``);
- every rank replays every rank's ``default_rng(seed + p)`` stream of
  samples and negatives, so it knows the whole global batch: the easy-edge
  mask covers all of its rows, and the step's numbers are the same at any
  process count (``process_count() == 1`` is the oracle of a multi-process
  run);
- a rank steps on its data rows and its block of edges
  (``parallel/dp.py::make_sharded_train_step``);
- evaluation shards the triples over the ranks without shuffling, each rank
  ranks its shard on the whole graph, and the rank vectors are gathered
  (``multihost.gather_ranks``).

``task.per_rank_easy_edges: true`` is the reference-DDP compat mode: each
data rank masks only its own rows' easy edges (``run.py:44-46``), so a run
matches a reference run at that world size instead of the single process.

As with ``DistributedSampler(drop_last=False)``, a shard is padded by
wrapping around, so a few evaluation triples may be counted twice when the
ranks do not divide them: the same small bias as upstream.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, Iterable, Optional

import numpy as np

from ultra_tpu_torch import tasks
from ultra_tpu_torch.graph import Graph
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.parallel import multihost
from ultra_tpu_torch.parallel.dp import make_sharded_train_step
from ultra_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_graph
from ultra_tpu_torch.train import eval as eval_lib
from ultra_tpu_torch.train.loop import init_train_state, mean_loss

logger = logging.getLogger("ultra_tpu_torch")


def evaluate_distributed(
    model: Ultra,
    graph: Graph,
    test_triples: np.ndarray,
    filtered_index: tasks.GraphIndex,
    batch_size: int = 8,
    metrics: Iterable[str] = ("mr", "mrr", "hits@1", "hits@3", "hits@10"),
    limit: Optional[int] = None,
) -> Dict[str, float]:
    """Filtered evaluation sharded over the ranks; every rank returns the
    whole (identical) metric dict."""
    trips = np.asarray(test_triples)
    if limit is not None and limit < len(trips):
        trips = trips[np.random.default_rng(0).choice(len(trips), size=limit, replace=False)]
    mine = multihost.shard_indices(len(trips), epoch=0, shuffle=False)
    vectors = eval_lib.collect_rankings(model, graph, trips[mine], filtered_index,
                                        batch_size=batch_size)
    return eval_lib.compute_metrics(metrics, *(multihost.gather_ranks(v) for v in vectors))


def train_distributed(
    train_cfg: dict,
    task_cfg: dict,
    model: Ultra,
    graph: Graph,
    train_index: tasks.GraphIndex,
    triples: np.ndarray,
    valid_triples: Optional[np.ndarray] = None,
    valid_graph: Optional[Graph] = None,
    valid_filtered: Optional[tasks.GraphIndex] = None,
    seed: int = 1024,
    lr: float = 5e-4,
    mesh: Optional[Mesh] = None,
) -> Ultra:
    """The multi-process twin of ``runner.train_and_validate``.

    ``train_cfg``: ``batch_size`` (per process, as the reference's per-rank
    DataLoader), ``num_epoch``, ``batch_per_epoch``, ``grad_accum``.
    ``task_cfg``: ``num_negative``, ``adversarial_temperature``,
    ``strict_negative``, ``per_rank_easy_edges``. ``triples`` (N, 3) are the
    supervision edges, ``graph`` the whole training graph on this rank's
    device; ``mesh`` (default: every rank on the data axis) may also cut the
    edges. After each epoch with ``valid_triples``, a sharded filtered
    validation; returns ``model`` with the best validation MRR's weights (the
    last ones without validation), equal on every rank."""
    num_epoch = int(train_cfg.get("num_epoch", 0))
    if num_epoch == 0:
        return model
    batch_size = int(train_cfg.get("batch_size", 8))
    batch_per_epoch = train_cfg.get("batch_per_epoch") or None
    num_negative = int(task_cfg.get("num_negative", 256))
    strict = bool(task_cfg.get("strict_negative", True))
    per_rank = bool(task_cfg.get("per_rank_easy_edges", False))
    remove_one_hop = model.cfg.entity_model.remove_one_hop

    world, pid = multihost.process_count(), multihost.process_index()
    mesh = mesh or make_mesh()
    if (batch_size * world) % mesh.data:
        raise ValueError(f"global batch {batch_size * world} does not divide over "
                         f"{mesh.data} data ranks")
    state = init_train_state(model, lr=lr)
    step_fn = make_sharded_train_step(
        mesh, adversarial_temperature=float(task_cfg.get("adversarial_temperature", 1.0)),
        num_negative=num_negative, per_rank_easy_edges=per_rank,
        grad_accum=int(train_cfg.get("grad_accum", 1)))
    block = shard_graph(graph, mesh)
    e_pad = graph.num_edges_padded

    rank_rngs = [np.random.default_rng(seed + p) for p in range(world)]
    steps_per_epoch = batch_per_epoch or math.ceil(len(triples) / (batch_size * world))
    best = None
    for epoch in range(num_epoch):
        t0 = time.time()
        shards = [multihost.shard_indices(len(triples), epoch=epoch, seed=seed, process_id=p,
                                          num_processes=world) for p in range(world)]
        losses = []
        for step in range(steps_per_epoch):
            all_rows = []
            for p in range(world):
                take = shards[p][(step * batch_size) % len(shards[p]):][:batch_size]
                if len(take) < batch_size:
                    take = np.concatenate([take, shards[p][: batch_size - len(take)]])
                all_rows.append(tasks.negative_sampling(train_index, triples[take], num_negative,
                                                        strict=strict, rng=rank_rngs[p]))
            global_rows = np.concatenate(all_rows)
            if per_rank:
                ew = np.stack([tasks.easy_edge_weights(train_index, rows, e_pad,
                                                       remove_one_hop=remove_one_hop)
                               for rows in np.split(global_rows, mesh.data)])
            else:
                ew = tasks.easy_edge_weights(train_index, global_rows, e_pad,
                                             remove_one_hop=remove_one_hop)
            losses.append(step_fn(state, block, global_rows, ew))
        logger.warning("[proc %d] epoch %d: avg bce %.6f (%.1fs)", pid, epoch,
                       mean_loss(losses), time.time() - t0)
        if valid_triples is not None:
            m = evaluate_distributed(state.model, valid_graph or graph, valid_triples,
                                     valid_filtered or train_index, batch_size=batch_size,
                                     metrics=("mrr",))
            logger.warning("[proc %d] valid after epoch %d: %s", pid, epoch, m)
            if best is None or m["mrr"] > best[0]:
                best = (m["mrr"], {k: v.detach().cpu().clone()
                                   for k, v in state.model.state_dict().items()})
    if best is not None:
        state.model.load_state_dict(best[1])
    return state.model
