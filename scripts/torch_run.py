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
config's ``output_dir``. ``ULTRA_DIST`` (the JAX script's multi-host launch)
is refused: ROADMAP A12. Reading the YAML needs jinja2 and PyYAML.
"""

import argparse
import logging
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ultra_tpu_torch.utils import config as config_lib


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, vars_ = config_lib.parse_args(parser)
    if os.environ.get("ULTRA_DIST"):
        raise SystemExit("ULTRA_DIST: multi-process runs of the port are ROADMAP A12")
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
