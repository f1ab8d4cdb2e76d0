"""UltraQuery pretraining on a mixture of query datasets.

Counterpart of ``ultra_tpu/query/pretrain.py`` (the reference's query-side
``JointDataset``, ``datasets_query.py:637-709``, trained as
``script/pretrain.py`` trains the link-prediction mixture): each step draws
one member with probability proportional to its training queries, then that
step's batch from it. Each member has its own base graph and
:class:`~ultra_tpu_torch.query.executor.DropoutPlanner`; the model and the
optimizer are shared. Validation averages MRR over the members (``fast_test``
of each member's validation queries). The numpy generator is drawn in the
JAX loop's order, so one seed gives both packages the same members, batches
and dropout.
"""

from __future__ import annotations

import logging
import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.query import ops
from ultra_tpu_torch.query.datasets import QueryDataset
from ultra_tpu_torch.query.executor import DropoutPlanner, QueryConfig
from ultra_tpu_torch.query.trainer import (
    answers_to_mask, dropout_planner, evaluate_queries, graph_host, make_step, plan_and_step,
    prepare_query_graph,
)
from ultra_tpu_torch.train.loop import init_train_state
from ultra_tpu_torch.utils import ckpt as ckpt_lib

logger = logging.getLogger("ultra_tpu_torch")


class QueryPretrainGraphs:
    """Each member's training and validation graphs on ``device``, its host
    arrays and training range; ``probs`` draws the members in proportion to
    their training queries. A member's planner is built at its first batch
    (seconds and about a GB of host memory on a large graph, wasted on a
    member the draws rarely pick)."""

    def __init__(self, datasets: Sequence[QueryDataset], device="cuda"):
        self.datasets = list(datasets)
        self.base_graphs = [prepare_query_graph(d.graphs[0], device=device)
                            for d in self.datasets]
        self.valid_graphs = [prepare_query_graph(d.graphs[1], device=device)
                             for d in self.datasets]
        self.hosts = [graph_host(d.graphs[0], g) for d, g in zip(self.datasets, self.base_graphs)]
        self._planners: List[Optional[DropoutPlanner]] = [None] * len(self.datasets)
        self.train_ranges = [d.split_ranges()[0] for d in self.datasets]
        counts = np.array([hi - lo for lo, hi in self.train_ranges], dtype=np.float64)
        self.probs = counts / counts.sum()

    def planner(self, gi: int) -> DropoutPlanner:
        if self._planners[gi] is None:
            t0 = time.time()
            self._planners[gi] = dropout_planner(self.hosts[gi], self.base_graphs[gi])
            logger.warning("built DropoutPlanner for member %d (%s) in %.1fs", gi,
                           self.datasets[gi].name, time.time() - t0)
        return self._planners[gi]


def pretrain_queries(cfg: dict, model: Ultra, qcfg: QueryConfig, graphs: QueryPretrainGraphs,
                     workdir: str, seed: int = 1024) -> Ultra:
    """Train ``model`` on the mixture ``graphs`` as ``cfg`` says and return
    it with the best validation checkpoint's weights. ``cfg`` as
    ``query/trainer.py::train_queries`` reads it, with
    ``train.grouped_projections`` on by default and ``batch_per_epoch``
    1000 by default."""
    train_cfg = cfg["train"]
    num_epoch = int(train_cfg.get("num_epoch", 1))
    batch_size = int(train_cfg.get("batch_size", 8))
    batch_per_epoch = int(train_cfg.get("batch_per_epoch") or 1000)
    fast_test = train_cfg.get("fast_test")
    log_interval = int(train_cfg.get("log_interval", 100))
    grouped = bool(train_cfg.get("grouped_projections", True))

    state = init_train_state(model, lr=float(cfg["optimizer"].get("lr", 5e-4)))
    ckpt_lib.resume(cfg, state, "query pretrain")
    step_fn = make_step(cfg, qcfg, grouped)
    rng = np.random.default_rng(seed)
    tracker = ckpt_lib.BestModelTracker(workdir)
    epoch_block = math.ceil(num_epoch / 10)

    def validate():
        mrrs = []
        for gi, d in enumerate(graphs.datasets):
            (_, _), (lo, hi), _ = d.split_ranges()
            idx = np.arange(lo, hi)
            if fast_test is not None and fast_test < len(idx):
                idx = np.random.default_rng(1024).choice(idx, size=fast_test, replace=False)
            m = evaluate_queries(state.model, qcfg, graphs.valid_graphs[gi], d, idx,
                                 batch_size=batch_size, metric_names=("mrr",),
                                 restrict_nodes=d.graphs[1].restrict_nodes)
            logger.warning("valid[%s]: mrr %.4f", d.name, m["mrr"])
            mrrs.append(m["mrr"])
        return float(np.mean(mrrs))

    epoch = 0
    for block_start in range(0, num_epoch, epoch_block):
        for epoch in range(block_start, min(num_epoch, block_start + epoch_block)):
            t0 = time.time()
            losses = []
            for step in range(batch_per_epoch):
                gi = int(rng.choice(len(graphs.datasets), p=graphs.probs))
                d = graphs.datasets[gi]
                lo, hi = graphs.train_ranges[gi]
                take = lo + rng.choice(hi - lo, size=min(batch_size, hi - lo), replace=False)
                while len(take) < batch_size:  # wrap for tiny members
                    take = np.concatenate([take, take[: batch_size - len(take)]])
                kind, operand = ops.decompose(d.queries[take])
                base = graphs.base_graphs[gi]
                target = answers_to_mask([d.easy_answers[i] for i in take],
                                         base.num_nodes).astype(np.float32)
                loss = plan_and_step(step_fn, state, grouped, base, graphs.hosts[gi],
                                     graphs.planner(gi), qcfg, rng, kind, operand, target)
                losses.append(loss)
                if step % log_interval == 0:
                    logger.warning("epoch %d step %d [%s] loss %.6f", epoch, step, d.name,
                                   float(loss))
            logger.warning("epoch %d: avg bce %.6f (%.1fs)", epoch,
                           float(torch.stack(losses).mean()), time.time() - t0)
        mrr = validate()
        logger.warning("avg valid mrr after epoch %d: %.4f", epoch, mrr)
        tracker.update(epoch + 1, mrr, state)

    return tracker.load_best(state.model)
