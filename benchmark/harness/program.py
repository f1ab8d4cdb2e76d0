"""The program under test, ``ultra_tpu_torch``, set up from a configuration
file and the benchmark's weights; and the controls of the comparison.

A control is a lower precision run in the program's place, which the
comparison that decides ``correct`` has to fail: ``tf32`` lets the
program's float32 matrix products run in TF32 (the nearest precision below
the configurations' float32 with TF32 off), ``bf16`` switches on the
program's own ``compute_dtype: bfloat16``. The benchmark's runs use no
control; ``benchmark/calibrate.py`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

CONTROLS = (None, "tf32", "bf16")


def ultra_config(cfg: dict, control=None):
    """The port's ``UltraConfig`` of a configuration file's models."""
    from ultra_tpu_torch.models.nbfnet import NBFNetConfig, UltraConfig

    fields = {f.name for f in dataclasses.fields(NBFNetConfig)}

    def model(side):
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg[side].items()
              if k in fields}
        if control == "bf16":
            kw["compute_dtype"] = "bfloat16"
        return NBFNetConfig(**kw)

    return UltraConfig(relation_model=model("relation_model"),
                       entity_model=model("entity_model"))


def ultra_model(cfg: dict, weights: dict, device, control=None):
    """The port's ``Ultra`` with the benchmark's ``weights`` copied in, in
    evaluation mode on ``device``. The program holds its own copy: the
    reference's weights stay the benchmark's."""
    from ultra_tpu_torch.models.nbfnet import Ultra

    model = Ultra(ultra_config(cfg, control))
    model.load_state_dict({k: v.detach().cpu() for k, v in weights.items()}, strict=True)
    return model.to(device).eval()


@contextlib.contextmanager
def tf32(on: bool):
    """float32 matrix products in TF32 (``on``) or in full float32, and the
    flags restored on the way out. The reference runs under ``tf32(False)``;
    the program runs as it sets itself, but for the ``tf32`` control."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def control_precision(control=None):
    """The context the program's window runs in under ``control``."""
    return tf32(True) if control == "tf32" else contextlib.nullcontext()


def launch_counters():
    """The program's rspmm launch counters, by wrapper name."""
    from ultra_tpu_torch.ops import rspmm_cuda, rspmm_minmax_cuda

    out = {}
    for module in (rspmm_cuda, rspmm_minmax_cuda):
        for name in dir(module):
            fn = getattr(module, name)
            if callable(fn) and hasattr(fn, "launches") and name.startswith("rspmm_"):
                out[name] = fn.launches
    return out
