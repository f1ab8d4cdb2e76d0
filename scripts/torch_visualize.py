"""Path-interpretation command line of the PyTorch/CUDA port: print the top
paths explaining a prediction. The twin of ``scripts/visualize.py``, with
the same flags and output, plus ``--device``:

  python scripts/torch_visualize.py -c config/transductive/inference.yaml \
      --dataset FB15k237 --ckpt ultra_3g.pth \
      --head 14 --relation 3 --tail 512 [--beam 10] [--topk 10] [--device cpu]

Prints each path as ``h -[r]-> x -[r']-> t  (importance w)``. Entity and
relation arguments are vocabulary ids of the dataset's test split. The edge
gradients run on the card (``--device cuda``, the default) through the
rspmm kernels and their edge-weight gradient; the beam search runs on the
host. Reading the YAML needs jinja2 and PyYAML.
"""

import argparse
import logging
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ultra_tpu_torch.utils import config as config_lib


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--head", type=int, required=True)
    parser.add_argument("--relation", type=int, required=True)
    parser.add_argument("--tail", type=int, required=True)
    parser.add_argument("--beam", type=int, default=10)
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, vars_ = config_lib.parse_args(parser, optional_vars=True)
    cfg = config_lib.load_config(args.config, context=vars_)
    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(message)s")

    from ultra_tpu_torch.models.visualize import format_paths, visualize_from_config

    try:
        dataset, explanation = visualize_from_config(
            cfg, args.head, args.relation, args.tail, num_beam=args.beam,
            path_topk=args.topk, device=args.device,
        )
    except ValueError as exc:  # a missing checkpoint or an id out of range
        raise SystemExit(str(exc)) from exc
    print("\n".join(format_paths(explanation, dataset, args.head, args.relation, args.tail)))


if __name__ == "__main__":
    main()
