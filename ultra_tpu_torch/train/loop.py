"""Model initialisation, the loss, the optimizer and the training step for
link prediction.

Counterpart of ``ultra_tpu/train/loop.py``. Negative sampling and the
easy-edge mask are host work (``tasks.py``); the step runs the forward and
the backward on the model's device and then one AdamW update:

    loss = BCE-with-logits(pred, [pos | negs]),
    negative weights = softmax(pred_neg / adversarial_temperature)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ultra_tpu_torch.graph import Graph, resolve_device
from ultra_tpu_torch.models.nbfnet import Ultra, UltraConfig, ultra_apply


@torch.no_grad()
def init_ultra_params(
    cfg: UltraConfig, generator: Optional[torch.Generator] = None, device="cuda"
) -> Ultra:
    """A fresh :class:`Ultra` with torch's default initialisers drawn from
    ``generator``: Linear weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    Embedding N(0, 1), LayerNorm ones and zeros.

    The draws happen on the CPU, so one seed gives the same weights on
    every device.
    """
    device = resolve_device(device)
    model = Ultra(cfg)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            bound = 1.0 / math.sqrt(module.in_features)
            module.weight.uniform_(-bound, bound, generator=generator)
            module.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(generator=generator)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model.to(device)


def self_adversarial_bce(pred, adversarial_temperature: float, num_negative: int):
    """Per-sample weighted BCE with logits; slot 0 of each row is the
    positive, the negatives weigh softmax(pred / temperature) (no gradient
    through the weights), or 1/num_negative each at temperature 0."""
    target = torch.zeros_like(pred)
    target[:, 0] = 1.0
    loss = F.binary_cross_entropy_with_logits(pred, target, reduction="none")
    if adversarial_temperature > 0:
        neg_weight = torch.softmax(pred[:, 1:].detach() / adversarial_temperature, dim=-1)
    else:
        neg_weight = torch.full_like(pred[:, 1:], 1.0 / num_negative)
    weight = torch.cat([torch.ones_like(pred[:, :1]), neg_weight], dim=-1)
    loss = (loss * weight).sum(dim=-1) / weight.sum(dim=-1)
    return loss.mean()


def mean_loss(losses) -> float:
    """The mean of an epoch's 0-d loss tensors, nan for an epoch of no
    step (as numpy's mean of an empty list)."""
    return float(torch.stack(losses).mean()) if losses else float("nan")


def make_optimizer(params, lr: float = 5e-4, weight_decay: float = 0.01):
    """AdamW as the JAX package's ``optax.adamw``: betas (0.9, 0.999), eps
    1e-8, decoupled weight decay on every parameter. Given explicitly:
    optax's and torch's defaults differ."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of steps taken."""

    model: Ultra
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(model: Ultra, lr: float = 5e-4, weight_decay: float = 0.01) -> TrainState:
    return TrainState(model, make_optimizer(model.parameters(), lr, weight_decay))


def make_train_step(
    adversarial_temperature: float = 1.0,
    num_negative: int = 256,
    grad_accum: int = 1,
    sync_grads=None,
):
    """Returns ``train_step(state, graph, batch, edge_weight) -> loss``.

    ``batch`` (B, 1+K, 3) int64 and ``edge_weight`` (E_pad,) f32, the
    batch's easy-edge mask (``tasks.easy_edge_weights``; pass
    ``graph.edge_weight`` for none), on the model's device. The step updates
    ``state`` in place and returns the loss as a 0-d tensor on the device;
    the gradients it applied stay in each parameter's ``.grad``.

    ``grad_accum`` > 1 runs ``gcd(B, grad_accum)`` equal micro-batches one
    after another and averages their gradients before the one update: the
    full-batch step, in less memory (the loss is a mean over rows, and the
    mask already covers the whole batch).

    ``sync_grads(model, loss) -> loss``, if given, runs between the backward
    and the update: ``parallel/dp.py`` averages the gradients and the loss
    over the ranks of a data group there.
    """

    def train_step(state: TrainState, graph: Graph, batch, edge_weight):
        graph = graph.replace_weights(edge_weight)
        model = state.model.train()
        accum = math.gcd(batch.shape[0], grad_accum)
        state.optimizer.zero_grad(set_to_none=True)
        loss = 0.0
        for micro in batch.chunk(accum):
            pred = ultra_apply(model, graph, micro)
            micro_loss = self_adversarial_bce(pred, adversarial_temperature, num_negative)
            (micro_loss / accum).backward()
            loss = loss + micro_loss.detach()
        loss = loss / accum
        if sync_grads is not None:
            loss = sync_grads(model, loss)
        state.optimizer.step()
        state.step += 1
        return loss

    return train_step
