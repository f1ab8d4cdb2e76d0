"""Model initialisation.

Counterpart of ``ultra_tpu/train/loop.py::init_ultra_params``. The training
step is a later slice of the port (ROADMAP A7).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ultra_tpu_torch.graph import resolve_device
from ultra_tpu_torch.models.nbfnet import Ultra, UltraConfig


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
