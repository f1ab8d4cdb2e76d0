"""Train-state checkpoints and best-model selection.

Counterpart of ``ultra_tpu/utils/ckpt.py``. A checkpoint is a ``.pth`` in
the reference layout, ``{"model": state_dict, "optimizer": ...,
"step": ...}``, so ``utils/torch_ckpt.py::load_ultra_checkpoint`` (and the
reference code) read its weights, and the optimizer state round-trips for an
exact resume.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from ultra_tpu_torch.train.loop import TrainState
from ultra_tpu_torch.utils.torch_ckpt import load_ultra_checkpoint


def save_train_state(path: str, state: TrainState) -> str:
    """Write ``state`` to ``path`` (through a temporary file, so a reader
    never sees half a checkpoint); returns ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    return path


def load_train_state(path: str, state: TrainState) -> TrainState:
    """Load a :func:`save_train_state` file into ``state`` (its model and
    optimizer, on their device) and return it."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


def resume(cfg: dict, state: TrainState, what: str = "train") -> None:
    """Load ``cfg["resume_from"]`` into ``state``; without it,
    ``$ULTRA_RESUME_FROM`` when that file exists (a supervisor relaunching a
    run sets it before the first checkpoint is written)."""
    resume_from = cfg.get("resume_from")
    if not resume_from:
        env_resume = os.environ.get("ULTRA_RESUME_FROM")
        if env_resume and os.path.exists(env_resume):
            resume_from = env_resume
    if resume_from:
        load_train_state(resume_from, state)
        logging.getLogger("ultra_tpu_torch").warning("resumed %s state from %s", what,
                                                     resume_from)


def load_model_checkpoint(path: str):
    """The model ``state_dict`` of a reference-layout ``.pth`` (a
    reference checkpoint, or one this package wrote), on the CPU, through
    ``utils/torch_ckpt.py::load_ultra_checkpoint``. The JAX package also
    reads its orbax directories; that is a JAX format, and the port raises
    for it: convert it with the JAX package's ``export_ultra_checkpoint``."""
    if os.path.isdir(path) or not path.endswith(".pth"):
        raise ValueError(
            f"{path!r} is not a .pth checkpoint: the port reads the reference .pth layout; "
            "an orbax directory is the JAX package's format (export it with "
            "ultra_tpu/utils/torch_ckpt.py::export_ultra_checkpoint)")
    return load_ultra_checkpoint(path)


class BestModelTracker:
    """Keep a checkpoint per validation, track the best metric, and reload
    the winner's weights at the end."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.best_metric = float("-inf")
        self.best_path: Optional[str] = None

    def update(self, epoch: int, metric: float, state: TrainState) -> None:
        """Save ``state`` as ``model_epoch_<epoch>.pth``; remember it if
        ``metric`` is the best so far."""
        path = save_train_state(os.path.join(self.workdir, f"model_epoch_{epoch}.pth"), state)
        if metric > self.best_metric:
            self.best_metric = metric
            self.best_path = path

    def load_best(self, model):
        """Load the best checkpoint's weights into ``model``; returns it."""
        assert self.best_path is not None, "no checkpoints saved"
        device = next(model.parameters()).device
        model.load_state_dict(
            torch.load(self.best_path, map_location=device, weights_only=True)["model"])
        return model
