"""Zero-shot complex-query evaluation (UltraQuery) with the PyTorch/CUDA port.
The twin of ``scripts/run_query.py`` for evaluation, with the same flags and
log lines, plus ``--device``:

  python scripts/torch_run_query.py -c config/ultraquery/transductive_synth.yaml \
      --dataset FB15k237LogicalQuery --root ./query-datasets-synth-held \
      --epochs 0 --bs 8 --bpe null --threshold 0.8 --ultra_ckpt null --qe_ckpt null

Each variable of the YAML template is a flag (``utils/config.py``); reading
the YAML needs jinja2 and PyYAML. The weights come from ``ultraquery_ckpt``,
else ``ultra_ckpt`` (a reference-layout ``.pth``; UltraQuery's
``model.model.*`` nesting is stripped), else a seeded initialisation
(``--seed``). The valid and test queries are answered on the card
(``--device cuda``, the default) or, when asked, on the CPU, and their
metrics logged as the JAX script logs them, then printed as one
``{"valid": ..., "test": ...}`` dict. ``$ULTRA_WORKDIR`` is the working
directory if set, else a new directory under the config's ``output_dir``.
Training (``num_epoch`` > 0, the JAX script's ``train_queries``) and the
pretraining mixture (``JointQueryDataset``) are ROADMAP A10 and A9, and
``ULTRA_DIST`` (a multi-process run) is ROADMAP A12: each raises.
"""

import argparse
import logging
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ultra_tpu_torch.utils import config as config_lib

logger = logging.getLogger("ultra_tpu_torch")


def run(cfg: dict, seed: int = 1024, device="cuda") -> dict:
    """The valid and test metrics of ``cfg`` (the YAML's content as a
    dict), logged as ``scripts/run_query.py`` logs them."""
    import torch

    from ultra_tpu_torch.graph import resolve_device
    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.query.datasets import build_query_dataset
    from ultra_tpu_torch.query.executor import QueryConfig
    from ultra_tpu_torch.query.trainer import evaluate_queries, prepare_query_graph
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.train.runner import model_config_from_dict
    from ultra_tpu_torch.utils.torch_ckpt import load_ultra_checkpoint

    device = resolve_device(device)
    if int(cfg["train"].get("num_epoch") or 0) > 0:
        raise NotImplementedError("training on queries (train_queries) is ROADMAP A10; "
                                  "run with --epochs 0")
    ds_cfg = dict(cfg["dataset"])
    name = ds_cfg.pop("class")
    root = os.path.expanduser(ds_cfg.pop("root", "./query-datasets"))
    dataset = build_query_dataset(name, root, **ds_cfg).load()

    model_cfg = cfg["model"]
    ultra_cfg = model_config_from_dict(model_cfg["model"])
    qcfg = QueryConfig(
        logic=model_cfg.get("logic", "product"),
        threshold=float(model_cfg.get("threshold") or 0.0),
        dropout_ratio=float(model_cfg.get("dropout_ratio", 0.25)),
        more_dropout=float(model_cfg.get("more_dropout", 0.0)),
    )
    ckpt = cfg.get("ultraquery_ckpt") or cfg.get("ultra_ckpt")
    if ckpt:
        model = Ultra(ultra_cfg)
        model.load_state_dict(load_ultra_checkpoint(ckpt))
    else:
        model = init_ultra_params(ultra_cfg, torch.Generator().manual_seed(seed), device="cpu")
    model = model.to(device)

    ranges = dataset.split_ranges()
    batch_size = int(cfg["train"].get("batch_size", 8))
    results = {}
    for split, (lo, hi) in zip(("valid", "test"), ranges[1:]):
        qg = dataset.graphs[("train", "valid", "test").index(split)]
        m = evaluate_queries(
            model, qcfg, prepare_query_graph(qg, device=device), dataset, np.arange(lo, hi),
            batch_size=batch_size, metric_names=cfg["task"].get("metric", ("mrr",)),
            restrict_nodes=qg.restrict_nodes,
        )
        logger.warning("%s metrics:", split)
        for k in sorted(m):
            logger.warning("  %s: %.4f", k, m[k])
        results[split] = m
    return results


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
    logger.warning("config: %s", dict(cfg))
    logger.warning("workdir: %s", workdir)
    print(run(cfg, seed=args.seed, device=args.device))


if __name__ == "__main__":
    main()
