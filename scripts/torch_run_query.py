"""Complex-query answering (UltraQuery) with the PyTorch/CUDA port:
training, and zero-shot or trained evaluation. The twin of
``scripts/run_query.py``, with the same flags and log lines, plus
``--device``:

  python scripts/torch_run_query.py -c config/ultraquery/transductive_synth.yaml \
      --dataset FB15k237LogicalQuery --root ./query-datasets-synth-held \
      --epochs 0 --bs 8 --bpe null --threshold 0.8 --ultra_ckpt null --qe_ckpt null

Each variable of the YAML template is a flag (``utils/config.py``); reading
the YAML needs jinja2 and PyYAML. The weights come from ``ultraquery_ckpt``,
else ``ultra_ckpt`` (a reference-layout ``.pth``; UltraQuery's
``model.model.*`` nesting is stripped), else a seeded initialisation
(``--seed``). With ``--epochs`` above 0 the model first trains on the
training queries with traversal dropout (``query/trainer.py::
train_queries``); a ``JointQueryDataset`` config pretrains on its members
(``query/pretrain.py::pretrain_queries``) and then logs each member's test
metrics. Everything runs on the card (``--device cuda``, the default) or,
when asked, on the CPU. The valid and test metrics are logged as the JAX
script logs them, then printed as one ``{"valid": ..., "test": ...}`` dict
(``{member: test metrics}`` for a mixture). ``$ULTRA_WORKDIR`` is the working
directory if set, else a new directory under the config's ``output_dir``.
``ULTRA_DIST`` (``coordinator:port,num_processes,proc_id`` per process, or
torchrun's environment; see ``scripts/torch_run.py``) starts a multi-process
run: evaluation shards the queries over the ranks, and ``train.data_parallel:
yes`` shards each training batch's queries over them.
"""

import argparse
import logging
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ultra_tpu_torch.parallel import multihost
from ultra_tpu_torch.utils import config as config_lib

logger = logging.getLogger("ultra_tpu_torch")


def run(cfg: dict, seed: int = 1024, device="cuda", workdir: str = None) -> dict:
    """Train as ``cfg`` (the YAML's content as a dict) says, if it trains,
    with checkpoints in ``workdir``; then the valid and test metrics, logged
    as ``scripts/run_query.py`` logs them (for a mixture, each member's test
    metrics)."""
    import torch

    from ultra_tpu_torch.graph import resolve_device
    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.query.datasets import build_query_dataset
    from ultra_tpu_torch.query.executor import QueryConfig
    from ultra_tpu_torch.query.pretrain import QueryPretrainGraphs, pretrain_queries
    from ultra_tpu_torch.query.trainer import (
        evaluate_queries, prepare_query_graph, train_queries,
    )
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.train.runner import model_config_from_dict
    from ultra_tpu_torch.utils.torch_ckpt import load_ultra_checkpoint

    device = resolve_device(device)
    workdir = workdir or os.path.join(os.path.expanduser(cfg.get("output_dir", "./output")),
                                      time.strftime("%Y-%m-%d-%H-%M-%S"))
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
    batch_size = int(cfg["train"].get("batch_size", 8))
    metric_names = cfg["task"].get("metric", ("mrr",))

    if isinstance(dataset, list):  # a JointQueryDataset mixture
        graphs = QueryPretrainGraphs(dataset, device=device)
        model = pretrain_queries(cfg, model, qcfg, graphs, workdir, seed=seed)
        results = {}
        for member in dataset:
            (_, _), (_, _), (lo, hi) = member.split_ranges()
            qg = member.graphs[2]
            m = evaluate_queries(model, qcfg, prepare_query_graph(qg, device=device), member,
                                 np.arange(lo, hi), batch_size=batch_size,
                                 metric_names=metric_names, restrict_nodes=qg.restrict_nodes)
            logger.warning("test metrics [%s]:", member.name)
            for k in sorted(m):
                logger.warning("  %s: %.4f", k, m[k])
            results[member.name] = m
        return results

    model = train_queries(cfg, model, qcfg, dataset, workdir, seed=seed)
    ranges = dataset.split_ranges()
    results = {}
    for split, (lo, hi) in zip(("valid", "test"), ranges[1:]):
        qg = dataset.graphs[("train", "valid", "test").index(split)]
        m = evaluate_queries(
            model, qcfg, prepare_query_graph(qg, device=device), dataset, np.arange(lo, hi),
            batch_size=batch_size, metric_names=metric_names, restrict_nodes=qg.restrict_nodes,
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
    multihost.initialize_from_env(args.device)
    cfg = config_lib.load_config(args.config, context=vars_)

    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(message)s")
    workdir = os.environ.get("ULTRA_WORKDIR") or os.path.join(
        os.path.expanduser(cfg.get("output_dir", "./output")),
        time.strftime("%Y-%m-%d-%H-%M-%S"),
    )
    os.makedirs(workdir, exist_ok=True)
    logger.warning("config: %s", dict(cfg))
    logger.warning("workdir: %s", workdir)
    print(run(cfg, seed=args.seed, device=args.device, workdir=workdir))


if __name__ == "__main__":
    main()
