"""Write a synthetic BetaE mixture of three query datasets for UltraQuery
pretraining with the PyTorch/CUDA port. The twin of
``scripts/gen_query_mixture.py``, with the same flags; one seed writes the
same files from both:

    python scripts/torch_gen_query_mixture.py --root ./query-datasets-synth [--tiny]
    python scripts/torch_run_query.py -c config/ultraquery/pretrain_mixture.yaml \\
        --root ./query-datasets-synth --epochs 1 --bs 8 --bpe 200

Three BetaE directories at three graph scales go under ``--root``
(``data/synthetic_queries.py::write_betae_dataset``), named as
``JointQueryDataset``'s members FB15k237, NELL995 and FB15k read them.
Numpy only: it needs no card.
"""

import argparse
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ultra_tpu_torch.data.synthetic_queries import write_betae_dataset

MEMBERS = [
    # (directory, nodes, direct relations, triples)
    ("FB15k-237-betae", 8000, 120, 120000),
    ("NELL-betae", 5000, 80, 60000),
    ("FB15k-betae", 3000, 50, 30000),
]

TINY_MEMBERS = [  # for a quick run on the CPU
    ("FB15k-237-betae", 300, 16, 2400),
    ("NELL-betae", 200, 12, 1500),
    ("FB15k-betae", 150, 10, 1000),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="./query-datasets-synth")
    ap.add_argument("--train-per-type", type=int, default=256)
    ap.add_argument("--eval-per-type", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true", help="a small mixture for the CPU")
    args = ap.parse_args()

    members = TINY_MEMBERS if args.tiny else MEMBERS
    if args.tiny:
        args.train_per_type = min(args.train_per_type, 24)
        args.eval_per_type = min(args.eval_per_type, 8)
    for i, (name, v, r, t) in enumerate(members):
        t0 = time.time()
        ne, nr = write_betae_dataset(
            args.root, name=name, num_nodes=v, num_direct_rel=r, num_triples=t,
            queries_per_type=args.eval_per_type, train_queries_per_type=args.train_per_type,
            seed=args.seed + i, rel_dist="zipf", categories=max(10, v // 400),
        )
        print(f"{name}: V={ne} R={nr} T={t} ({time.time() - t0:.1f}s) -> "
              f"{os.path.join(args.root, name)}", flush=True)


if __name__ == "__main__":
    main()
