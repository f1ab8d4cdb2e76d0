"""Link-prediction command line of the PyTorch/CUDA port: zero-shot
evaluation, fine-tuning, or training from scratch on one dataset. The twin
of ``scripts/run.py``, with the same flags and output, plus ``--device``:

  # zero-shot from a reference-layout checkpoint
  python scripts/torch_run.py -c config/inductive/inference.yaml \
      --dataset FBIngram --version fb-25 --epochs 0 --bpe null --ckpt ultra_3g.pth

  # fine-tune
  python scripts/torch_run.py -c config/transductive/inference.yaml \
      --dataset CoDExMedium --epochs 1 --bpe 1000 --ckpt ultra_3g.pth [--device cpu]

Each variable of the YAML template is a flag (``utils/config.py``).
Prints the ``{"valid": metrics, "test": metrics}`` dict of
``train/runner.py::run_link_prediction``, which runs on the card
(``--device cuda``, the default) or, when asked, on the CPU. Checkpoints go
to ``$ULTRA_WORKDIR`` if it is set, else to a new directory under the
config's ``output_dir``. Reading the YAML needs jinja2 and PyYAML.

A multi-process run (``train/distributed.py``) starts one process per rank,
each with ``ULTRA_DIST="coordinator:port,num_processes,proc_id"`` as the JAX
script takes it, or under torchrun, whose environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``)
is read when ``ULTRA_DIST`` is unset:

  ULTRA_DIST=localhost:29500,2,0 python scripts/torch_run.py -c ... &
  ULTRA_DIST=localhost:29500,2,1 python scripts/torch_run.py -c ...
  torchrun --nproc-per-node 2 scripts/torch_run.py -c ...

Each rank takes the card ``cuda:(local rank % device count)`` and the
``nccl`` backend when each rank of its host has its own card, else ``gloo``
(also with ``--device cpu``). A host's rank count is ``LOCAL_WORLD_SIZE``,
which torchrun sets; beside ``ULTRA_DIST`` set it to put several ranks on
one card, or each host runs one rank a card.
"""

import argparse
import logging
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ultra_tpu_torch.parallel import multihost
from ultra_tpu_torch.utils import config as config_lib


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, vars_ = config_lib.parse_args(parser)
    multihost.initialize_from_env(args.device)
    cfg = config_lib.load_config(args.config, context=vars_)

    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(message)s")
    workdir = os.environ.get("ULTRA_WORKDIR") or os.path.join(
        os.path.expanduser(cfg.get("output_dir", "./output")),
        time.strftime("%Y-%m-%d-%H-%M-%S"),
    )
    os.makedirs(workdir, exist_ok=True)
    logger = logging.getLogger("ultra_tpu_torch")
    logger.warning("config: %s", dict(cfg))
    logger.warning("workdir: %s", workdir)

    from ultra_tpu_torch.train import runner

    results = runner.run_link_prediction(cfg, workdir, seed=args.seed,
                                         checkpoint=cfg.get("checkpoint"), device=args.device)
    print(results)


if __name__ == "__main__":
    main()
