"""One-command zero-shot complex-query (CLQA) parity run against the
reference README tables, with the PyTorch/CUDA port. The twin of
``scripts/parity_run_query.py``, with the same flags, rows, CSV, report and
last line, plus ``--device``:

  python scripts/torch_parity_run_query.py --ckpt ultraquery.pth
  python scripts/torch_parity_run_query.py -d query_transductive \
      --ckpt ultraquery.pth --threshold 0.8

For each BetaE-format query dataset whose files are present it answers the
test queries zero-shot with an ultra_3g-width model (the checkpoint's
weights, a reference-layout ``.pth``; ``null`` draws them from ``--seed``)
through ``query/trainer.py::evaluate_queries``, as
``scripts/torch_run_query.py`` evaluates, and writes a row of EPFO and
negation MRR and Hits@10; group means are compared with the published CLQA
numbers (README.md:361-431, UltraQuery paper and PyG rows). Datasets whose
files are absent are listed and skipped. The rows go to a CSV
(``--output``), the report to ``parity_query_report_<time>.json`` and, as
one JSON object, to the last line of standard output.

A dataset whose files fail to load gets a row with its ``error`` and the
sweep goes on; an error of the model or the card ends the run non-zero.
Runs on the card (``--device cuda``, the default) or, when asked, the CPU.
"""

import argparse
import csv
import json
import logging
import math
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ultra_tpu_torch.data.zoo import (  # noqa: E402
    QUERY_GROUPS, instantiate_query, iter_targets, query_is_staged, target_name,
)

logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(message)s")
logger = logging.getLogger("ultra_tpu_torch")

# README.md:361-431 — group -> row -> (EPFO mrr, EPFO h@10, neg mrr, neg h@10)
REFERENCE_CLQA = {
    "query_all": {
        "ultraquery_paper": (0.301, 0.428, 0.152, 0.264),
        "ultraquery_pyg": (0.309, 0.432, 0.178, 0.286),
    },
    "query_transductive": {"ultraquery_pyg": (0.411, None, None, None)},
    "query_inductive_e": {"ultraquery_pyg": (0.312, None, None, None)},
    "query_inductive_er": {"ultraquery_pyg": (0.280, None, None, None)},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--datasets",
                    default="query_transductive,query_inductive_e,query_inductive_er")
    ap.add_argument("--ckpt", required=True, help="ultraquery checkpoint (.pth) or 'null'")
    ap.add_argument("--root", default="./query-datasets")
    ap.add_argument("--threshold", type=float, default=0.8,
                    help="score threshold (README.md:359 multi-source fix)")
    ap.add_argument("--logic", default="product")
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--output", default=None)
    ap.add_argument("--seed", type=int, default=1024)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import numpy as np
    import torch

    from ultra_tpu_torch.graph import resolve_device
    from ultra_tpu_torch.models.nbfnet import Ultra, UltraConfig
    from ultra_tpu_torch.query.executor import QueryConfig
    from ultra_tpu_torch.query.trainer import evaluate_queries, prepare_query_graph
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.utils.ckpt import load_model_checkpoint

    targets = list(dict.fromkeys(iter_targets(args.datasets)))
    present = [(n, v) for n, v in targets if query_is_staged(n, v, args.root)]
    missing = [t for t in targets if t not in present]
    if missing:
        logger.warning(
            "missing raw data for %d query dataset(s): %s — stage with "
            "scripts/fetch_data.py -d query_all",
            len(missing), ",".join(target_name(n, v) for n, v in missing),
        )
    if not present:
        print(json.dumps({"error": "no query datasets staged",
                          "missing": [target_name(n, v) for n, v in missing]}))
        return

    device = resolve_device(args.device)
    ultra_cfg = UltraConfig()  # ultra_3g: 6 layers of 64 in both models
    qcfg = QueryConfig(logic=args.logic, threshold=args.threshold, dropout_ratio=0.0)
    if args.ckpt and args.ckpt != "null":
        model = Ultra(ultra_cfg)
        model.load_state_dict(load_model_checkpoint(args.ckpt))
    else:
        model = init_ultra_params(ultra_cfg, torch.Generator().manual_seed(args.seed),
                                  device="cpu")
    model = model.to(device)

    stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
    out_csv = args.output or f"parity_query_results_{stamp}.csv"
    rows = []
    for name, version in present:
        tgt = target_name(name, version)
        logger.warning(">>> %s", tgt)
        t0 = time.time()
        try:
            ds = instantiate_query(name, version, args.root).load()
        except Exception as exc:  # noqa: BLE001 — a dataset's data: record it, keep sweeping
            logger.warning("%s FAILED: %s: %s", tgt, type(exc).__name__, str(exc)[:300],
                           exc_info=True)
            rows.append({"dataset": tgt, "error": type(exc).__name__})
            continue
        (_, _), (_, _), (lo, hi) = ds.split_ranges()
        qg = ds.graphs[2]
        m = evaluate_queries(model, qcfg, prepare_query_graph(qg, device=device), ds,
                             np.arange(lo, hi), batch_size=args.bs,
                             metric_names=("mrr", "hits@10"), restrict_nodes=qg.restrict_nodes)
        row = {"dataset": tgt,
               "epfo_mrr": round(m.get("[EPFO] mrr", float("nan")), 4),
               "epfo_hits@10": round(m.get("[EPFO] hits@10", float("nan")), 4),
               "neg_mrr": round(m.get("[negation] mrr", float("nan")), 4),
               "neg_hits@10": round(m.get("[negation] hits@10", float("nan")), 4),
               "time_s": round(time.time() - t0, 1)}
        rows.append(row)
        logger.warning("%s: %s", tgt, row)
        with open(out_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row.keys()) + ["error"])
            if f.tell() == 0:
                w.writeheader()
            w.writerow(row)

    by_name = {r["dataset"]: r for r in rows if "epfo_mrr" in r}
    report = {"ckpt": args.ckpt, "threshold": args.threshold, "rows": rows, "groups": {}}
    for group, refs in REFERENCE_CLQA.items():
        members = [target_name(n, v) for n, v in QUERY_GROUPS[group]]
        got = [by_name[m] for m in members if m in by_name]
        if not got:
            continue

        def mean(key):
            vals = [r[key] for r in got if not math.isnan(r[key])]
            return round(sum(vals) / len(vals), 4) if vals else None

        entry = {"n_run": len(got), "n_total": len(members),
                 "complete": len(got) == len(members),
                 "epfo_mrr": mean("epfo_mrr"), "epfo_hits@10": mean("epfo_hits@10"),
                 "neg_mrr": mean("neg_mrr"), "neg_hits@10": mean("neg_hits@10"),
                 "reference": refs}
        if entry["complete"] and entry["epfo_mrr"] is not None:
            for ck, (rm, *_rest) in refs.items():
                entry[f"delta_epfo_mrr_vs_{ck}"] = round(entry["epfo_mrr"] - rm, 4)
        report["groups"][group] = entry
        logger.warning("group %s: %s", group, entry)

    with open(f"parity_query_report_{stamp}.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
