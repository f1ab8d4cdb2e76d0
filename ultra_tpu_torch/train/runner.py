"""Fine-tuning with validation: the training loop over one dataset.

Counterpart of ``ultra_tpu/train/runner.py::train_and_validate``. The host
samples negatives and builds each batch's easy-edge mask
(``tasks.py``); the model's device runs the step
(``train/loop.py::make_train_step``); after every block of epochs a
filtered validation (``train/eval.py``) scores the model and a checkpoint is
kept, and the best one's weights are loaded at the end
(``utils/ckpt.py``). The dataset loaders and the command line are ROADMAP
A6.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict

import numpy as np
import torch

from ultra_tpu_torch import tasks
from ultra_tpu_torch.data.kg import KGDataset, KGSplit
from ultra_tpu_torch.graph import Graph
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.train import eval as eval_lib
from ultra_tpu_torch.train.loop import init_train_state, make_train_step
from ultra_tpu_torch.utils import ckpt as ckpt_lib

logger = logging.getLogger("ultra_tpu_torch")


def triples_of(split: KGSplit) -> np.ndarray:
    """(T, 3) (h, t, r) supervision triples of a split."""
    return np.concatenate(
        [split.target_edge_index, split.target_edge_type[None]], axis=0
    ).T.copy()


def train_and_validate(
    cfg: dict,
    model: Ultra,
    graphs: Dict[str, Graph],
    dataset: KGDataset,
    filtered: Dict[str, tasks.GraphIndex],
    workdir: str,
    seed: int = 1024,
) -> Ultra:
    """Train ``model`` on ``dataset.train`` as ``cfg`` says and return it
    with the best validation checkpoint's weights.

    ``cfg`` has the YAML's sections: ``train`` (``num_epoch``,
    ``batch_size``, ``batch_per_epoch``, ``grad_accum``, ``fast_test``,
    ``checkpoint_interval_steps``), ``task`` (``num_negative``,
    ``adversarial_temperature``, ``strict_negative``), ``optimizer``
    (``lr``) and ``resume_from``. ``graphs`` holds the ``"train"`` and
    ``"valid"`` graphs on the model's device, ``filtered["valid"]`` the
    validation filter. Checkpoints go to ``workdir``; without
    ``resume_from``, ``$ULTRA_RESUME_FROM`` names a crash checkpoint to
    resume from when that file exists (a supervisor relaunching a run sets
    it before the first checkpoint is written).
    """
    train_cfg, task_cfg = cfg["train"], cfg["task"]
    num_epoch = int(train_cfg.get("num_epoch", 0))
    if num_epoch == 0:
        return model

    batch_size = int(train_cfg.get("batch_size", 8))
    batch_per_epoch = train_cfg.get("batch_per_epoch") or None
    num_negative = int(task_cfg.get("num_negative", 256))
    adv_temp = float(task_cfg.get("adversarial_temperature", 1.0))
    strict = bool(task_cfg.get("strict_negative", True))

    state = init_train_state(model, lr=float(cfg["optimizer"].get("lr", 5e-4)))
    resume_from = cfg.get("resume_from")
    if not resume_from:
        env_resume = os.environ.get("ULTRA_RESUME_FROM")
        if env_resume and os.path.exists(env_resume):
            resume_from = env_resume
    if resume_from:
        ckpt_lib.load_train_state(resume_from, state)
        logger.warning("resumed train state from %s", resume_from)
    step_fn = make_train_step(adversarial_temperature=adv_temp, num_negative=num_negative,
                              grad_accum=int(train_cfg.get("grad_accum", 1)))

    train_graph = graphs["train"]
    device = train_graph.device
    train = dataset.train
    train_index = tasks.GraphIndex.build(train.edge_index, train.edge_type,
                                         train.num_nodes, train.num_relations)
    triples = triples_of(train)
    rng = np.random.default_rng(seed)
    tracker = ckpt_lib.BestModelTracker(workdir)

    steps_per_epoch = batch_per_epoch or math.ceil(len(triples) / batch_size)
    epoch_block = math.ceil(num_epoch / 10)
    fast_valid = train_cfg.get("fast_test")
    ckpt_interval = train_cfg.get("checkpoint_interval_steps")

    epoch = 0
    for block_start in range(0, num_epoch, epoch_block):
        for epoch in range(block_start, min(num_epoch, block_start + epoch_block)):
            perm = rng.permutation(len(triples))
            losses = []
            t0 = time.time()
            for step in range(steps_per_epoch):
                take = perm[(step * batch_size) % len(triples):][:batch_size]
                if len(take) < batch_size:
                    take = np.concatenate([take, perm[: batch_size - len(take)]])
                batch = tasks.negative_sampling(
                    train_index, triples[take], num_negative, strict=strict, rng=rng)
                ew = tasks.easy_edge_weights(train_index, batch, train_graph.num_edges_padded)
                losses.append(step_fn(state, train_graph,
                                      torch.as_tensor(batch, device=device),
                                      torch.as_tensor(ew, device=device)))
                if ckpt_interval and (step + 1) % int(ckpt_interval) == 0:
                    ckpt_lib.save_train_state(os.path.join(workdir, "model_latest.pth"), state)
            logger.warning("epoch %d: avg bce %.6f (%.1fs, %d steps)", epoch,
                           float(torch.stack(losses).mean()), time.time() - t0,
                           steps_per_epoch)

        val_metrics = eval_lib.evaluate(
            state.model, graphs["valid"], triples_of(dataset.valid), filtered["valid"],
            batch_size=batch_size, metrics=("mrr",), limit=fast_valid,
        )
        logger.warning("valid after epoch %d: %s", epoch, val_metrics)
        tracker.update(epoch + 1, val_metrics["mrr"], state)

    return tracker.load_best(state.model)
