"""Pretraining ULTRA on a mixture of graphs.

Counterpart of ``ultra_tpu/train/pretrain.py`` (the reference's
``script/pretrain.py``). Each step draws one member graph with probability
proportional to its number of training triples, then that step's batch from
it (``pretrain.py:26-37``): the host samples the batch, its negatives and
its easy-edge mask (``tasks.py``), and the model's device runs the step
(``train/loop.py::make_train_step``); the model and the optimizer are shared
by every member. After each block of epochs a filtered validation on every
member (``fast_test`` of each member's validation triples) averages MRR,
and a checkpoint is kept; the best one's weights are loaded at the end.

The numpy generator is drawn in the JAX loop's order (member, batch,
negatives; the mask draws nothing), so one seed gives both packages the
same members and batches. The JAX package's diagnosis of a TPU-worker
crash (``is_worker_crash``, ``crash_diagnostic``) has no counterpart.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Sequence

import numpy as np
import torch

from ultra_tpu_torch import tasks
from ultra_tpu_torch.data.kg import KGDataset
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.train import eval as eval_lib
from ultra_tpu_torch.train.loop import init_train_state, make_train_step, mean_loss
from ultra_tpu_torch.train.runner import prepare_graph, triples_of
from ultra_tpu_torch.utils import ckpt as ckpt_lib

logger = logging.getLogger("ultra_tpu_torch")


class PretrainGraphs:
    """Each member's training and validation graphs on ``device``, its host
    index of the training edges, its filter (every split's targets) and its
    training triples; ``graph_probs`` draws the members in proportion to
    their training triples."""

    def __init__(self, datasets: Sequence[KGDataset], device="cuda"):
        self.datasets = list(datasets)
        self.train_graphs = [prepare_graph(d.train, device=device) for d in self.datasets]
        self.valid_graphs = [prepare_graph(d.valid, device=device) for d in self.datasets]
        self.train_indexes = [
            tasks.GraphIndex.build(d.train.edge_index, d.train.edge_type, d.train.num_nodes,
                                   d.train.num_relations)
            for d in self.datasets
        ]
        self.filtered = []
        for d in self.datasets:
            splits = (d.train, d.valid, d.test)
            ei = np.concatenate([s.target_edge_index for s in splits], axis=1)
            et = np.concatenate([s.target_edge_type for s in splits])
            self.filtered.append(tasks.GraphIndex.build(ei, et, d.train.num_nodes,
                                                        d.train.num_relations))
        self.train_triples = [triples_of(d.train) for d in self.datasets]
        counts = np.array([len(t) for t in self.train_triples], dtype=np.float64)
        self.graph_probs = counts / counts.sum()

    def sample(self, rng: np.random.Generator, batch_size: int, num_negative: int,
               strict: bool, remove_one_hop: bool):
        """One step's (member, batch (B, 1+K, 3), easy-edge mask (E_pad,)),
        host arrays, drawn from ``rng`` as the JAX loop draws them."""
        gi = int(rng.choice(len(self.datasets), p=self.graph_probs))
        trips = self.train_triples[gi]
        take = rng.choice(len(trips), size=min(batch_size, len(trips)), replace=False)
        if len(take) < batch_size:
            take = np.concatenate([take, rng.choice(len(trips), size=batch_size - len(take))])
        batch = tasks.negative_sampling(self.train_indexes[gi], trips[take], num_negative,
                                        strict=strict, rng=rng)
        ew = tasks.easy_edge_weights(self.train_indexes[gi], batch,
                                     self.train_graphs[gi].num_edges_padded,
                                     remove_one_hop=remove_one_hop)
        return gi, batch, ew


def pretrain(cfg: dict, model: Ultra, graphs: PretrainGraphs, workdir: str,
             seed: int = 1024) -> Ultra:
    """Train ``model`` on the mixture ``graphs`` as ``cfg`` says and return
    it with the best validation checkpoint's weights.

    ``cfg`` has the YAML's sections: ``train`` (``num_epoch``,
    ``batch_size``, ``batch_per_epoch``, ``grad_accum``, ``fast_test``,
    ``log_interval``), ``task`` (``num_negative``,
    ``adversarial_temperature``, ``strict_negative``), ``optimizer``
    (``lr``) and ``resume_from``. Each epoch ends with
    ``workdir/model_latest.pth``; without ``resume_from``,
    ``$ULTRA_RESUME_FROM`` names a checkpoint to resume from when that file
    exists. ``batch_per_epoch`` 0 takes no step (the epoch's logged loss is
    nan, as the JAX package's); null raises ``ValueError``, where the JAX
    package raises ``TypeError``."""
    train_cfg, task_cfg = cfg["train"], cfg["task"]
    num_epoch = int(train_cfg.get("num_epoch", 10))
    batch_size = int(train_cfg.get("batch_size", 64))
    batch_per_epoch = train_cfg.get("batch_per_epoch", 1000)
    if batch_per_epoch is None:
        raise ValueError("train.batch_per_epoch is null: pretraining needs a number of steps "
                         "an epoch (--bpe)")
    batch_per_epoch = int(batch_per_epoch)
    num_negative = int(task_cfg.get("num_negative", 512))
    strict = bool(task_cfg.get("strict_negative", True))
    fast_test = train_cfg.get("fast_test")
    log_interval = int(train_cfg.get("log_interval", 100))
    remove_one_hop = model.cfg.entity_model.remove_one_hop

    state = init_train_state(model, lr=float(cfg["optimizer"].get("lr", 5e-4)))
    ckpt_lib.resume(cfg, state, "pretrain")
    step_fn = make_train_step(
        adversarial_temperature=float(task_cfg.get("adversarial_temperature", 1.0)),
        num_negative=num_negative, grad_accum=int(train_cfg.get("grad_accum", 1)))

    rng = np.random.default_rng(seed)
    tracker = ckpt_lib.BestModelTracker(workdir)
    epoch_block = math.ceil(num_epoch / 10)

    def validate():
        mrrs = []
        for gi, d in enumerate(graphs.datasets):
            m = eval_lib.evaluate(
                state.model, graphs.valid_graphs[gi], triples_of(d.valid), graphs.filtered[gi],
                batch_size=max(batch_size // 8, 1), metrics=("mrr",), limit=fast_test,
                rng=np.random.default_rng(seed))
            logger.warning("valid[%s]: %s", d.name, m)
            mrrs.append(m["mrr"])
        return float(np.mean(mrrs))

    epoch = 0
    for block_start in range(0, num_epoch, epoch_block):
        for epoch in range(block_start, min(num_epoch, block_start + epoch_block)):
            t0 = time.time()
            losses = []
            for step in range(batch_per_epoch):
                gi, batch, ew = graphs.sample(rng, batch_size, num_negative, strict,
                                              remove_one_hop)
                graph = graphs.train_graphs[gi]
                loss = step_fn(state, graph, torch.as_tensor(batch, device=graph.device),
                               torch.as_tensor(ew, device=graph.device))
                losses.append(loss)
                if step % log_interval == 0:
                    logger.warning("epoch %d step %d loss %.6f", epoch, step, float(loss))
            logger.warning("epoch %d: avg bce %.6f (%.1fs)", epoch,
                           mean_loss(losses), time.time() - t0)
            ckpt_lib.save_train_state(os.path.join(workdir, "model_latest.pth"), state)
        mrr = validate()
        logger.warning("avg valid mrr after epoch %d: %.4f", epoch, mrr)
        tracker.update(epoch + 1, mrr, state)

    return tracker.load_best(state.model)
