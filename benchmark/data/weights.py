"""The model's weights, made on the device from the seed.

Torch's default initialisers, as the published model starts from them: a
linear layer's weight and bias U(-1/sqrt(fan in), 1/sqrt(fan in)), an
embedding N(0, 1), a layer norm ones and zeros. All uniform draws are one
call, all normal draws another, on a ``torch.Generator`` of the device.
The names and shapes are ``reference/ultra.py::param_specs``'s, the
published checkpoint's; the benchmark loads the dict into the program and
hands the same dict to the reference.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.ultra import param_specs


def make_weights(cfg: dict, seed: int, device) -> dict:
    specs = param_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(shape) for _, shape, init in specs if init[0] == kind)
             for kind in ("uniform", "normal")}
    draws = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device),
             "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    offset = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, init in specs:
        kind = init[0]
        if kind in draws:
            n = math.prod(shape)
            t = draws[kind][offset[kind]:offset[kind] + n].view(shape)
            offset[kind] += n
            out[name] = (t * 2 - 1) * init[1] if kind == "uniform" else t.clone()
        else:
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
    return out
