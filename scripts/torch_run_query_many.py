"""Zero-shot complex-query evaluation over several datasets with the
PyTorch/CUDA port, one CSV row each. The twin of
``scripts/run_query_many.py``, with the same flags, plus ``--device``:

  python scripts/torch_run_query_many.py -c config/ultraquery/transductive.yaml \
      -d FB15k237LogicalQuery,NELL995LogicalQuery --qe_ckpt ultraquery.pth \
      --threshold 0.8 [--device cpu]

``-d`` names the datasets (``name`` or ``name:version``) under ``--root``.
The weights come from ``--qe_ckpt``, else ``--ultra_ckpt`` (reference-layout
``.pth``), else a seeded initialisation. Each dataset's test queries are
answered on the card (``--device cuda``, the default) or, when asked, on the
CPU; a row of its metrics and seconds is appended to ``--output`` (by
default a new ``ultraquery_results_<time>.csv``). Reading the YAML needs
jinja2 and PyYAML.
"""

import argparse
import csv
import logging
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ultra_tpu_torch.utils import config as config_lib

SEEDS = [1024, 42, 1337, 512, 256]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-d", "--datasets", required=True)
    parser.add_argument("-reps", "--repeats", type=int, default=1)
    parser.add_argument("--qe_ckpt", default=None)
    parser.add_argument("--ultra_ckpt", default=None)
    parser.add_argument("--threshold", type=float, default=0.0)
    parser.add_argument("--bs", type=int, default=16)
    parser.add_argument("--root", default="./query-datasets")
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, _ = parser.parse_known_args()

    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(message)s")
    logger = logging.getLogger("ultra_tpu_torch")

    import torch

    from ultra_tpu_torch.graph import resolve_device
    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.query.datasets import build_query_dataset
    from ultra_tpu_torch.query.executor import QueryConfig
    from ultra_tpu_torch.query.trainer import evaluate_queries, prepare_query_graph
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.train.runner import model_config_from_dict
    from ultra_tpu_torch.utils.torch_ckpt import load_ultra_checkpoint

    device = resolve_device(args.device)
    out_csv = args.output or f"ultraquery_results_{time.strftime('%Y-%m-%d-%H-%M-%S')}.csv"
    cfg = config_lib.load_config(
        args.config,
        context={"dataset": "_", "epochs": 0, "bs": args.bs, "bpe": "null",
                 "threshold": args.threshold, "ultra_ckpt": args.ultra_ckpt,
                 "qe_ckpt": args.qe_ckpt},
    )
    ultra_cfg = model_config_from_dict(cfg["model"]["model"])
    qcfg = QueryConfig(logic=cfg["model"].get("logic", "product"), threshold=args.threshold,
                       dropout_ratio=0.0)
    ckpt = args.qe_ckpt or args.ultra_ckpt
    if ckpt:
        model = Ultra(ultra_cfg)
        model.load_state_dict(load_ultra_checkpoint(ckpt))
    else:
        model = init_ultra_params(ultra_cfg, torch.Generator().manual_seed(SEEDS[0]),
                                  device="cpu")
    model = model.to(device)

    for target in [d.strip() for d in args.datasets.split(",") if d.strip()]:
        if ":" in target:
            name, version = target.split(":")
            kwargs = {"version": version}
        else:
            name, kwargs = target, {}
        dataset = build_query_dataset(name, args.root, **kwargs).load()
        (_, _), (_, _), (lo, hi) = dataset.split_ranges()
        graph = prepare_query_graph(dataset.graphs[2], device=device)
        t0 = time.time()
        m = evaluate_queries(
            model, qcfg, graph, dataset, np.arange(lo, hi), batch_size=args.bs,
            metric_names=cfg["task"].get("metric", ("mrr", "hits@10")),
            restrict_nodes=dataset.graphs[2].restrict_nodes,
        )
        row = {"dataset": target, "time_s": round(time.time() - t0, 1)}
        row.update({k: round(v, 4) for k, v in m.items()})
        write_header = not os.path.exists(out_csv)
        with open(out_csv, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row.keys()))
            if write_header:
                writer.writeheader()
            writer.writerow(row)
        logger.warning("%s: EPFO mrr %.4f", target, m.get("[EPFO] mrr", float("nan")))

    logger.warning("results written to %s", out_csv)


if __name__ == "__main__":
    main()
