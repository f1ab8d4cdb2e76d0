"""Link prediction from a config: the dataset, the weights, fine-tuning with
validation, filtered evaluation, and the helpers the command lines share.

Counterpart of ``ultra_tpu/train/runner.py``. :func:`run_link_prediction`
is what ``scripts/torch_run.py`` and ``scripts/torch_run_many.py`` run: a
YAML config's dataset, model and weights, an optional fine-tune
(:func:`train_and_validate`), then filtered valid and test metrics. In
training the host samples negatives and builds each batch's easy-edge mask
(``tasks.py``); the model's device runs the step
(``train/loop.py::make_train_step``); after every block of epochs a
filtered validation (``train/eval.py``) scores the model and a checkpoint
is kept, and the best one's weights are loaded at the end
(``utils/ckpt.py``). In a process group of more than one process the run
takes the multi-process branch (``train/distributed.py``), as the JAX
package's does.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ultra_tpu_torch import tasks
from ultra_tpu_torch.data import kg
from ultra_tpu_torch.data.kg import KGDataset, KGSplit, split_to_graph
from ultra_tpu_torch.graph import Graph, pad_bucket, resolve_device
from ultra_tpu_torch.models.nbfnet import NBFNetConfig, Ultra, UltraConfig
from ultra_tpu_torch.parallel import multihost
from ultra_tpu_torch.train import eval as eval_lib
from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params, make_train_step
from ultra_tpu_torch.utils import ckpt as ckpt_lib

logger = logging.getLogger("ultra_tpu_torch")


def model_config_from_dict(model_cfg: dict) -> UltraConfig:
    """The YAML's ``model`` section -> :class:`UltraConfig` (the reference's
    class dispatch, ``models.py:14-15``).

    One of the JAX package's keys is not carried: ``precision`` (the TPU
    matrix units' pass count; the port's kernels are exact f32).
    ``remove_one_hop`` is kept: :func:`train_and_validate` reads it from the
    entity model. ``compute_dtype`` is carried as the JAX package carries
    it: ``bfloat16`` runs each conv's rspmm on bf16 operands with f32
    accumulation (``models/layers.py``); any type but ``float32`` and
    ``bfloat16`` raises ``ValueError``."""

    def nbf(cfg: dict, project_relations: bool) -> NBFNetConfig:
        cfg = dict(cfg)
        cfg.pop("class", None)
        return NBFNetConfig(
            input_dim=cfg.get("input_dim", 64),
            hidden_dims=tuple(cfg.get("hidden_dims", (64,) * 6)),
            num_relation=4 if not project_relations else 1,
            message_func=cfg.get("message_func", "distmult"),
            aggregate_func=cfg.get("aggregate_func", "sum"),
            short_cut=bool(cfg.get("short_cut", True)),
            layer_norm=bool(cfg.get("layer_norm", True)),
            activation=cfg.get("activation", "relu"),
            concat_hidden=bool(cfg.get("concat_hidden", False)),
            num_mlp_layer=int(cfg.get("num_mlp_layer", 2)),
            remove_one_hop=bool(cfg.get("remove_one_hop", False)),
            remat=bool(cfg.get("remat", False)),
            compute_dtype=cfg.get("compute_dtype"),
            project_relations=project_relations,
        )

    return UltraConfig(
        relation_model=nbf(model_cfg["relation_model"], project_relations=False),
        entity_model=nbf(model_cfg["entity_model"], project_relations=True),
    )


def prepare_graph(split: KGSplit, device="cuda") -> Graph:
    """The split's graph on ``device``, padded as the JAX package pads it:
    the message edges to a multiple of 2048 and the relation graph's
    (data-dependent, up to 4*R^2) edges to a multiple of 1024. The padding
    is weight-0 edges, left out of the edge layouts; the host beam search of
    ``models/visualize.py`` sees it as the JAX package's does."""
    return split_to_graph(split, device=device,
                          pad_edges_to=pad_bucket(split.edge_index.shape[1], 2048),
                          pad_rel_edges_bucket=1024)


def build_filtered_index(dataset: KGDataset, dataset_name: str,
                         task_name: str) -> Dict[str, tasks.GraphIndex]:
    """The validation and test filters: the edges whose tails (or heads) a
    filtered ranking does not count against a triple (``run.py:263-291``).

    Transductive: every split's targets over the training graph's nodes.
    ``InductiveInference``: for the datasets of
    ``kg.INDUCTIVE_FILTER_WITH_INFERENCE``, one filter for both, the
    inference graph with the validation and test targets, sized by the test
    split; for the others, the test graph with its targets, and the
    training graph with the validation targets sized by the validation
    split (HM's and MTDEA's validation splits have more nodes than the
    training graph)."""
    train, valid, test = dataset.train, dataset.valid, dataset.test
    build = tasks.GraphIndex.build
    if task_name == "InductiveInference":
        if dataset_name in kg.INDUCTIVE_FILTER_WITH_INFERENCE:
            ei = np.concatenate(
                [valid.edge_index, valid.target_edge_index, test.target_edge_index], axis=1)
            et = np.concatenate([valid.edge_type, valid.target_edge_type, test.target_edge_type])
            idx = build(ei, et, test.num_nodes, test.num_relations)
            return {"valid": idx, "test": idx}
        return {
            "valid": build(np.concatenate([train.edge_index, valid.target_edge_index], axis=1),
                           np.concatenate([train.edge_type, valid.target_edge_type]),
                           valid.num_nodes, valid.num_relations),
            "test": build(np.concatenate([test.edge_index, test.target_edge_index], axis=1),
                          np.concatenate([test.edge_type, test.target_edge_type]),
                          test.num_nodes, test.num_relations),
        }
    ei = np.concatenate(
        [train.target_edge_index, valid.target_edge_index, test.target_edge_index], axis=1)
    et = np.concatenate([train.target_edge_type, valid.target_edge_type, test.target_edge_type])
    idx = build(ei, et, train.num_nodes, train.num_relations)
    return {"valid": idx, "test": idx}


def default_metrics(dataset_name: str, metrics: Sequence[str]) -> List[str]:
    """``metrics``, each on the tail direction alone (``<metric>-tail``) for
    the datasets of ``kg.TAIL_ONLY_EVAL``."""
    if dataset_name in kg.TAIL_ONLY_EVAL:
        return [f"{m}-tail" for m in metrics]
    return list(metrics)


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
    ckpt_lib.resume(cfg, state)
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
                ew = tasks.easy_edge_weights(
                    train_index, batch, train_graph.num_edges_padded,
                    remove_one_hop=model.cfg.entity_model.remove_one_hop)
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


def retry_with_remat(train, model: Ultra, what: str = "train"):
    """``train(model)``, and if it runs out of device memory, ``train`` of
    the same model with both parts recomputing their convs in the backward
    (``remat``) from the weights ``model`` started with, on its device. Out
    of memory with remat already on, or any other error, is raised. Returns
    what ``train`` returns."""
    cfg = model.cfg
    # steps update the weights in place before memory may run out, so the
    # retry starts from a host copy of the first ones
    initial = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    device = next(model.parameters()).device
    try:
        return train(model)
    except torch.cuda.OutOfMemoryError as exc:
        if cfg.relation_model.remat and cfg.entity_model.remat:
            raise
        failure = str(exc)
    # out of the except block, the traceback no longer holds the failed
    # step's tensors; free them before the retry allocates its own
    logger.warning(
        "%s step OOMed HBM (%s...); retrying with remat: yes — set "
        "model.{relation_model,entity_model}.remat explicitly to avoid "
        "the doubled first compile", what, failure[:120],
    )
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = Ultra(dataclasses.replace(
        cfg, relation_model=dataclasses.replace(cfg.relation_model, remat=True),
        entity_model=dataclasses.replace(cfg.entity_model, remat=True)))
    model.load_state_dict(initial)
    return train(model.to(device))


def run_link_prediction(
    cfg: dict,
    workdir: str,
    seed: int = 1024,
    checkpoint: Optional[str] = None,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """A full run as ``scripts/torch_run.py`` makes it: build the dataset
    (``cfg["dataset"]``: its ``class``, ``root`` and constructor keys), the
    model (``cfg["model"]``) with the weights of ``checkpoint`` (a
    reference-layout ``.pth``) or fresh ones drawn from ``seed``, and the
    graph of each split on ``device``; fine-tune for ``cfg["train"]``'s
    epochs (none at 0: zero-shot); then evaluate the valid and test splits,
    filtered, with ``cfg["task"]``'s metrics at the configured batch size.
    Returns ``{"valid": metrics, "test": metrics}``, each also logged.

    If fine-tuning runs out of device memory, it starts again from the
    weights the run started with, with both models recomputing their convs
    in the backward (``remat``); out of memory with remat already on, or any
    other error, is raised.

    In a process group of more than one process (``multihost.initialize``)
    each rank runs on its own card (``cuda``) or the CPU, fine-tunes with
    ``train/distributed.py::train_distributed`` (``train.batch_size`` rows
    per process, the gradients averaged over the ranks) and evaluates with
    ``evaluate_distributed``, as the JAX package's multi-host branch: no
    remat retry and no checkpoint there."""
    device = resolve_device(multihost.rank_device(device))
    os.makedirs(workdir, exist_ok=True)
    ds_cfg = dict(cfg["dataset"])
    ds_name = ds_cfg.pop("class")
    root = os.path.expanduser(ds_cfg.pop("root", os.path.join(workdir, "kg-datasets")))
    dataset = kg.build_dataset(ds_name, root, **ds_cfg).load()

    ultra_cfg = model_config_from_dict(cfg["model"])
    if checkpoint:
        model = Ultra(ultra_cfg)
        model.load_state_dict(ckpt_lib.load_model_checkpoint(checkpoint))
        model = model.to(device)
    else:
        model = init_ultra_params(ultra_cfg, torch.Generator().manual_seed(seed), device)
    graphs = {split: prepare_graph(getattr(dataset, split), device=device)
              for split in ("train", "valid", "test")}
    task_name = cfg["task"].get("name", "TransductiveInference")
    filtered = build_filtered_index(dataset, ds_name, task_name)
    metrics = default_metrics(ds_name, cfg["task"].get("metric", ("mr", "mrr", "hits@10")))
    batch_size = int(cfg["train"].get("batch_size", 8))

    if multihost.process_count() > 1:
        from ultra_tpu_torch.train.distributed import evaluate_distributed, train_distributed

        train = dataset.train
        train_index = tasks.GraphIndex.build(train.edge_index, train.edge_type,
                                             train.num_nodes, train.num_relations)
        model = train_distributed(
            cfg["train"], cfg["task"], model, graphs["train"], train_index, triples_of(train),
            valid_triples=triples_of(dataset.valid), valid_graph=graphs["valid"],
            valid_filtered=filtered["valid"], seed=seed,
            lr=float(cfg["optimizer"].get("lr", 5e-4)))
        results = {}
        for split in ("valid", "test"):
            results[split] = evaluate_distributed(
                model, graphs[split], triples_of(getattr(dataset, split)), filtered[split],
                batch_size=batch_size, metrics=metrics)
            logger.warning("%s metrics: %s", split, results[split])
        return results

    if int(cfg["train"].get("num_epoch", 0)) > 0:  # zero-shot takes no step
        model = retry_with_remat(
            lambda m: train_and_validate(cfg, m, graphs, dataset, filtered, workdir, seed=seed),
            model)

    results = {}
    for split in ("valid", "test"):
        results[split] = eval_lib.evaluate(
            model, graphs[split], triples_of(getattr(dataset, split)), filtered[split],
            batch_size=batch_size, metrics=metrics)
        logger.warning("%s metrics: %s", split, results[split])
    return results
