"""Reference checkpoints (.pth) and JAX parameter trees -> the port's
``state_dict``.

The port's modules use the reference checkpoint's parameter names, so a
reference ``.pth`` loads with ``load_state_dict`` once its ``model.``
nesting is stripped:

  {"model": state_dict, "optimizer": ...}
  relation_model.layers.{i}.layer_norm.{weight,bias}
  relation_model.layers.{i}.linear.{weight,bias}        # torch (out, in)
  relation_model.layers.{i}.relation.weight             # (4, 64)
  entity_model.layers.{i}.layer_norm.{weight,bias}
  entity_model.layers.{i}.linear.{weight,bias}
  entity_model.layers.{i}.relation_projection.{0,2}.{weight,bias}
  entity_model.mlp.{0,2}.{weight,bias}

UltraQuery checkpoints nest the same under ``model.model.*``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_ultra_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The Ultra ``state_dict`` of a reference ``.pth``, on the CPU."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    sd = state["model"] if isinstance(state, dict) and "model" in state else state
    # strip every uniform "model." level (UltraQuery wraps Ultra twice)
    while sd and all(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()}
    return dict(sd)


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))  # a contiguous copy


def _linear(sd, prefix: str, w, b) -> None:
    sd[f"{prefix}.weight"] = _tensor(np.asarray(w).T)  # (in, out) -> (out, in)
    sd[f"{prefix}.bias"] = _tensor(b)


def _nbfnet_from_jax(params: dict, model: str, sd: Dict[str, torch.Tensor]) -> None:
    for i, layer in enumerate(params["layers"]):
        p = f"{model}.layers.{i}"
        _linear(sd, f"{p}.linear", layer["linear"]["w"], layer["linear"]["b"])
        if "layer_norm" in layer:
            sd[f"{p}.layer_norm.weight"] = _tensor(layer["layer_norm"]["scale"])
            sd[f"{p}.layer_norm.bias"] = _tensor(layer["layer_norm"]["bias"])
        if "relation" in layer:
            sd[f"{p}.relation.weight"] = _tensor(layer["relation"])
        if "relation_projection" in layer:
            rp = layer["relation_projection"]
            _linear(sd, f"{p}.relation_projection.0", rp["w1"], rp["b1"])
            _linear(sd, f"{p}.relation_projection.2", rp["w2"], rp["b2"])
        if "relation_linear" in layer:
            rl = layer["relation_linear"]
            _linear(sd, f"{p}.relation_linear", rl["w"], rl["b"])
    for j, lin in enumerate(params.get("mlp", [])):
        _linear(sd, f"{model}.mlp.{2 * j}", lin["w"], lin["b"])


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX parameter tree given as numpy
    arrays (``{"relation_model": ..., "entity_model": ...}``): linear
    weights are transposed to torch's (out, in), LayerNorm's ``scale``
    becomes ``weight``."""
    sd: Dict[str, torch.Tensor] = {}
    _nbfnet_from_jax(tree["relation_model"], "relation_model", sd)
    _nbfnet_from_jax(tree["entity_model"], "entity_model", sd)
    return sd
