"""One-command zero-shot parity run against the reference README tables,
with the PyTorch/CUDA port. The twin of ``scripts/parity_run.py``, with the
same flags, rows, CSV, report and last line, plus ``--device``:

  python scripts/torch_parity_run.py -d FB15k237,WN18RR --ckpt ultra_3g.pth
  python scripts/torch_parity_run.py -d inductive_e,inductive_er \
      --ckpt ultra_3g.pth --root ./kg-datasets

For each dataset whose raw files (or cache) are present it evaluates the
checkpoint zero-shot (``train/runner.py::run_link_prediction`` with
``num_epoch: 0``) and writes a row of test MRR and Hits@10; a group that ran
complete is compared with the reference's published aggregates
(README.md:104-145, ULTRA 3g/4g). Datasets whose files are absent are listed
and skipped. The rows go to a CSV (``--output``), the report to
``parity_report_<time>.json`` and, as one JSON object, to the last line of
standard output.

``--precision``: the port's kernels compute in exact f32 and matrix
products run with TF32 off, which is the JAX package's ``highest`` (its
README-table mode); only ``highest`` is accepted, and ``default`` (the TPU's
fewer-pass matrix products) is refused.

A dataset whose files fail to load gets a row with its ``error`` and the
sweep goes on; an error of the model or the card ends the run non-zero.
Runs on the card (``--device cuda``, the default) or, when asked, the CPU.
"""

import argparse
import csv
import json
import logging
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)

from ultra_tpu_torch.data.zoo import (  # noqa: E402
    GROUPS, INDUCTIVE_CLASSES, instantiate, is_staged, iter_targets, target_name,
)

logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(message)s")
logger = logging.getLogger("ultra_tpu_torch")

# Reference aggregate rows (README.md:118-144): group -> ckpt -> (MRR, H@10)
REFERENCE_AGGREGATES = {
    "inductive_e": {
        "ultra_3g_paper": (0.430, 0.566), "ultra_4g_paper": (0.439, 0.580),
        "ultra_3g_pyg": (0.420, 0.562), "ultra_4g_pyg": (0.444, 0.588),
    },
    "inductive_er": {
        "ultra_3g_paper": (0.345, 0.512), "ultra_4g_paper": (0.352, 0.518),
        "ultra_3g_pyg": (0.344, 0.511), "ultra_4g_pyg": (0.344, 0.513),
    },
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config",
                    default=os.path.join(REPO, "config", "transductive", "inference.yaml"))
    ap.add_argument("--inductive-config",
                    default=os.path.join(REPO, "config", "inductive", "inference.yaml"))
    ap.add_argument("-d", "--datasets", default="inductive_e,inductive_er")
    ap.add_argument("--ckpt", required=True, help="checkpoint path (.pth), or 'null'")
    ap.add_argument("--root", default="./kg-datasets")
    ap.add_argument("--output", default=None)
    ap.add_argument("--seed", type=int, default=1024)
    ap.add_argument("--precision", default="highest", choices=["highest"],
                    help="'highest' (exact f32, the README-table mode) only")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from ultra_tpu_torch.train import runner
    from ultra_tpu_torch.utils import config as config_lib

    targets = list(dict.fromkeys(iter_targets(args.datasets)))
    present = [(n, v) for n, v in targets if is_staged(n, v, args.root)]
    missing = [t for t in targets if t not in present]
    if missing:
        logger.warning(
            "missing raw data for %d dataset(s): %s — stage with "
            "scripts/fetch_data.py (see DATA_MANIFEST.md)",
            len(missing), ",".join(target_name(n, v) for n, v in missing),
        )
    if not present:
        print(json.dumps({"error": "no datasets staged",
                          "missing": [target_name(n, v) for n, v in missing]}))
        return

    stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
    out_csv = args.output or f"parity_results_{stamp}.csv"
    rows = []
    for name, version in present:
        tgt = target_name(name, version)
        cfg = config_lib.load_config(
            args.inductive_config if name in INDUCTIVE_CLASSES else args.config,
            context={"dataset": name, "version": version, "epochs": 0,
                     "bpe": "null", "ckpt": args.ckpt},
        )
        if version is not None:
            cfg["dataset"]["version"] = version
        cfg["dataset"]["root"] = args.root
        cfg["train"]["num_epoch"] = 0
        workdir = os.path.join("output", f"parity-{tgt.replace(':', '-')}")
        logger.warning(">>> %s (precision=%s)", tgt, args.precision)
        t0 = time.time()
        try:  # the files: processed and cached here, read from the cache by the run
            instantiate(name, version, args.root).load()
        except Exception as exc:  # noqa: BLE001 — a dataset's data: record it, keep sweeping
            logger.warning("%s FAILED: %s: %s", tgt, type(exc).__name__, str(exc)[:300],
                           exc_info=True)
            rows.append({"dataset": tgt, "error": type(exc).__name__})
            continue
        results = runner.run_link_prediction(cfg, workdir, seed=args.seed,
                                             checkpoint=cfg.get("checkpoint"),
                                             device=args.device)
        row = {"dataset": tgt,
               "mrr": round(results["test"].get("mrr", float("nan")), 4),
               "hits@10": round(results["test"].get("hits@10", float("nan")), 4),
               "time_s": round(time.time() - t0, 1)}
        rows.append(row)
        logger.warning("%s: %s", tgt, row)
        with open(out_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["dataset", "mrr", "hits@10", "time_s", "error"])
            if f.tell() == 0:
                w.writeheader()
            w.writerow(row)

    # group aggregates vs the reference rows (deltas only when a group ran complete)
    by_name = {r["dataset"]: r for r in rows if "mrr" in r}
    report = {"ckpt": args.ckpt, "precision": args.precision, "rows": rows, "groups": {}}
    for group, refs in REFERENCE_AGGREGATES.items():
        members = [target_name(n, v) for n, v in GROUPS[group]]
        got = [by_name[m] for m in members if m in by_name]
        if not got:
            continue
        mrr = sum(r["mrr"] for r in got) / len(got)
        h10 = sum(r["hits@10"] for r in got) / len(got)
        entry = {"n_run": len(got), "n_total": len(members),
                 "complete": len(got) == len(members),
                 "mrr": round(mrr, 4), "hits@10": round(h10, 4), "reference": refs}
        if entry["complete"]:
            for ck, (rm, rh) in refs.items():
                entry[f"delta_mrr_vs_{ck}"] = round(mrr - rm, 4)
        report["groups"][group] = entry
        logger.warning("group %s: %s", group, entry)

    with open(f"parity_report_{stamp}.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
