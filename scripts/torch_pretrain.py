"""Pretraining ULTRA on a mixture of graphs with the PyTorch/CUDA port. The
twin of ``scripts/pretrain.py``, with the same flags and log lines, plus
``--device``:

  python scripts/torch_pretrain.py -c config/transductive/pretrain_synth.yaml \
      --epochs 1 --bpe 100 [--device cpu]

Each variable of the YAML template is a flag (``utils/config.py``); reading
the YAML needs jinja2 and PyYAML. The config's ``dataset`` is a
``JointDataset`` (its ``graphs`` and ``root``); the weights come from
``checkpoint`` (a reference-layout ``.pth``) or a seeded initialisation
(``--seed``). Training runs on the card (``--device cuda``, the default) or,
when asked, on the CPU (``train/pretrain.py::pretrain``). If a step runs out
of device memory, pretraining starts again from the first weights with both
models recomputing their convs in the backward (``remat``). Checkpoints, and
at the end ``model_final.pth``, go to ``$ULTRA_WORKDIR`` if it is set, else to
a new directory under the config's ``output_dir``.
"""

import argparse
import logging
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ultra_tpu_torch.utils import config as config_lib

logger = logging.getLogger("ultra_tpu_torch")


def run(cfg: dict, workdir: str, seed: int = 1024, device="cuda"):
    """Pretrain as ``cfg`` (the YAML's content as a dict) says; returns the
    model with the best validation's weights, also saved as
    ``workdir/model_final.pth``."""
    import torch

    from ultra_tpu_torch.data import kg
    from ultra_tpu_torch.graph import resolve_device
    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.train.pretrain import PretrainGraphs, pretrain
    from ultra_tpu_torch.train.runner import model_config_from_dict, retry_with_remat
    from ultra_tpu_torch.utils import ckpt as ckpt_lib

    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    ds_cfg = dict(cfg["dataset"])
    ds_cfg.pop("class")
    root = os.path.expanduser(ds_cfg.pop("root", "./kg-datasets"))
    datasets = kg.JointDataset(root, ds_cfg.pop("graphs")).load()

    ultra_cfg = model_config_from_dict(cfg["model"])
    model = Ultra(ultra_cfg)
    if cfg.get("checkpoint"):
        model.load_state_dict(ckpt_lib.load_model_checkpoint(cfg["checkpoint"]))
    else:
        model = init_ultra_params(ultra_cfg, torch.Generator().manual_seed(seed), device="cpu")
    graphs = PretrainGraphs(datasets, device=device)
    model = retry_with_remat(lambda m: pretrain(cfg, m, graphs, workdir, seed=seed),
                             model.to(device), "pretrain")
    torch.save({"model": model.state_dict()}, os.path.join(workdir, "model_final.pth"))
    logger.warning("saved final model to %s", workdir)
    return model


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, vars_ = config_lib.parse_args(parser)
    cfg = config_lib.load_config(args.config, context=vars_)

    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(message)s")
    workdir = os.environ.get("ULTRA_WORKDIR") or os.path.join(
        os.path.expanduser(cfg.get("output_dir", "./output")),
        time.strftime("%Y-%m-%d-%H-%M-%S"),
    )
    os.makedirs(workdir, exist_ok=True)
    logger.warning("config: %s", dict(cfg))
    run(cfg, workdir, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
