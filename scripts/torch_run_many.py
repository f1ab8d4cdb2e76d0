"""Link prediction over several datasets in turn, with one CSV row per run:
the twin of ``scripts/run_many.py`` (zero-shot, fine-tuning or training
sweeps, 5 fixed seeds, per-dataset epoch tables), with the same flags and
rows, plus ``--device``:

  python scripts/torch_run_many.py -c config/transductive/inference.yaml \
      -d CoDExSmall,WDsinger --ckpt ultra_3g.pth [--device cpu]
  python scripts/torch_run_many.py -c config/inductive/inference.yaml \
      -d FB15k237Inductive:v1,NELLInductive:v4 --ckpt ultra_3g.pth --finetune

Each run is ``train/runner.py::run_link_prediction`` on the card (``--device
cuda``, the default) or, when asked, on the CPU; its checkpoints go to
``output/<dataset>-<seed>`` under the working directory. Reading the YAML
needs jinja2 and PyYAML.
"""

import argparse
import csv
import logging
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ultra_tpu_torch.utils import config as config_lib

# (num_epochs, batches_per_epoch); None = all train triples (run_many.py:25-115)
DEFAULT_FINETUNING_CONFIG = {
    "CoDExSmall": (1, 4000), "CoDExMedium": (1, 4000), "CoDExLarge": (1, 2000),
    "FB15k237": (1, None), "WN18RR": (1, None), "YAGO310": (1, 2000),
    "DBpedia100k": (1, 1000), "AristoV4": (1, 2000), "ConceptNet100k": (1, 2000),
    "NELL995": (1, None), "Hetionet": (1, 4000),
    "WDsinger": (3, None), "FB15k237_10": (1, None), "FB15k237_20": (1, None),
    "FB15k237_50": (1, 1000), "NELL23k": (3, None),
    "FB15k237Inductive": (1, None), "WN18RRInductive": (1, None),
    "NELLInductive": (3, None),
    "ILPC2022:small": (3, None), "ILPC2022:large": (1, 1000),
    "NLIngram": (3, None), "FBIngram": (3, None), "WKIngram": (3, None),
    "WikiTopicsMT1": (3, None), "WikiTopicsMT2": (3, None),
    "WikiTopicsMT3": (3, None), "WikiTopicsMT4": (3, None),
    "Metafam": (3, None), "FBNELL": (3, None),
    "HM": (1, 100),
}

DEFAULT_TRAIN_CONFIG = {
    "CoDExSmall": (10, 1000), "CoDExMedium": (10, 1000), "CoDExLarge": (10, 1000),
    "FB15k237": (10, 1000), "WN18RR": (10, 1000), "YAGO310": (10, 2000),
    "DBpedia100k": (10, 1000), "AristoV4": (10, 1000), "ConceptNet100k": (10, 1000),
    "NELL995": (10, 1000), "Hetionet": (10, 1000),
    "WDsinger": (10, 1000), "FB15k237_10": (10, 1000), "FB15k237_20": (10, 1000),
    "FB15k237_50": (10, 1000), "NELL23k": (10, 1000),
    "FB15k237Inductive": (10, None), "WN18RRInductive": (10, None),
    "NELLInductive": (10, None),
    "ILPC2022:small": (10, None), "ILPC2022:large": (10, 1000),
    "NLIngram": (10, None), "FBIngram": (10, None), "WKIngram": (10, None),
    "WikiTopicsMT1": (10, None), "WikiTopicsMT2": (10, None),
    "WikiTopicsMT3": (10, None), "WikiTopicsMT4": (10, None),
    "Metafam": (10, None), "FBNELL": (10, None),
    "HM": (10, 1000),
}

SEEDS = [1024, 42, 1337, 512, 256]  # run_many.py:132


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-d", "--datasets", required=True,
                        help="comma list, Name or Name:version")
    parser.add_argument("-reps", "--repeats", type=int, default=1)
    parser.add_argument("-ft", "--finetune", action="store_true")
    parser.add_argument("-tr", "--train", action="store_true")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--root", default="./kg-datasets")
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, _ = parser.parse_known_args()

    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(message)s")
    logger = logging.getLogger("ultra_tpu_torch")

    from ultra_tpu_torch.train import runner

    datasets = [d.strip() for d in args.datasets.split(",") if d.strip()]
    out_csv = args.output or f"ultra_tpu_torch_results_{time.strftime('%Y-%m-%d-%H-%M-%S')}.csv"

    for target in datasets:
        if ":" in target:
            name, version = target.split(":")
            ds_kwargs = {"version": version}
        else:
            name, version = target, None
            ds_kwargs = {}

        for rep in range(args.repeats):
            seed = SEEDS[rep % len(SEEDS)]
            cfg = config_lib.load_config(
                args.config,
                context={"dataset": name, "version": version, "epochs": 0,
                         "bpe": "null", "ckpt": args.ckpt or "null"},
            )
            cfg["dataset"].update(ds_kwargs)
            cfg["dataset"]["root"] = args.root
            table_key = target if target in DEFAULT_FINETUNING_CONFIG else name
            if args.finetune:
                epochs, bpe = DEFAULT_FINETUNING_CONFIG.get(table_key, (1, None))
            elif args.train:
                epochs, bpe = DEFAULT_TRAIN_CONFIG.get(table_key, (10, 1000))
            else:
                epochs, bpe = 0, None
            cfg["train"]["num_epoch"] = epochs
            cfg["train"]["batch_per_epoch"] = bpe
            if args.train:
                cfg["checkpoint"] = None

            workdir = os.path.join("output", f"{target.replace(':', '-')}-{seed}")
            logger.warning(">>> %s seed=%d epochs=%s bpe=%s", target, seed, epochs, bpe)
            t0 = time.time()
            results = runner.run_link_prediction(
                cfg, workdir, seed=seed, checkpoint=cfg.get("checkpoint"), device=args.device)
            row = {"dataset": target, "seed": seed, "time_s": round(time.time() - t0, 1)}
            for k, v in results["test"].items():
                row[k] = round(v, 4)
            write_header = not os.path.exists(out_csv)
            with open(out_csv, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(row.keys()))
                if write_header:
                    writer.writeheader()
                writer.writerow(row)
            logger.warning("%s: %s", target, row)

    logger.warning("results written to %s", out_csv)


if __name__ == "__main__":
    main()
