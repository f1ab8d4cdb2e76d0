"""Serving command line of the PyTorch/CUDA port: load a checkpoint and a
knowledge graph, and answer link-prediction and complex-query requests over
HTTP (``ultra_tpu_torch/server.py``). The twin of ``scripts/serve.py``, with
the same flags plus ``--device``:

  python scripts/torch_serve.py -c config/transductive/inference.yaml \
      --dataset FB15k237 --ckpt ultra_3g.pth --port 8080 [--device cpu]

  curl localhost:8080/v1/meta
  curl -d '{"queries": [{"head": 14, "relation": 3, "k": 5}]}' \
      localhost:8080/v1/predict
  curl -d '{"queries": [[[3, [1]], [7, [2]]]], "k": 5}' \
      localhost:8080/v1/query        # a 2i intersection, BetaE nesting

The graph served is the dataset's test split's message graph, on the card
(``--device cuda``, the default) or, when asked, on the CPU. The template's
variables are optional flags here (serving reads no ``train.*``); reading
the YAML needs jinja2 and PyYAML.
"""

import argparse
import logging
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ultra_tpu_torch.utils import config as config_lib


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--batch-size", type=int, default=8, dest="batch_size")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, vars_ = config_lib.parse_args(parser, optional_vars=True)
    cfg = config_lib.load_config(args.config, context=vars_)
    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(message)s")
    log = logging.getLogger("ultra_tpu_torch")

    from ultra_tpu_torch.data import kg
    from ultra_tpu_torch.serve import UltraPredictor
    from ultra_tpu_torch.server import PredictionService, make_http_server
    from ultra_tpu_torch.train.runner import model_config_from_dict

    ckpt = cfg.get("checkpoint")
    if not ckpt:
        raise SystemExit("torch_serve.py needs a checkpoint (--ckpt)")
    ds_cfg = dict(cfg["dataset"])
    ds_name = ds_cfg.pop("class")
    root = os.path.expanduser(ds_cfg.pop("root", "./kg-datasets"))
    dataset = kg.build_dataset(ds_name, root, **ds_cfg).load()

    log.warning("loading %s on %s/test ...", ckpt, ds_name)
    predictor = UltraPredictor.from_checkpoint(
        ckpt, dataset.test, cfg=model_config_from_dict(cfg["model"]),
        batch_size=int(args.batch_size), device=args.device)
    httpd = make_http_server(PredictionService(predictor), host=args.host, port=int(args.port))
    log.warning("serving %s on http://%s:%d (predict + query + meta)",
                ds_name, *httpd.server_address)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
