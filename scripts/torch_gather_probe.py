"""The TPU gather probes' counterpart on the card: time the row gather G1 and
the lane gather G2 (``ultra_tpu_torch/ops/gather_cuda.py``) at the probes'
shapes, and the share of a sum rspmm that gathering its source rows takes.

  python3 scripts/torch_gather_probe.py [--out build/gather_probe.json]

The probes under ``scripts/`` (``exp_dma_gather*.py``, ``exp_vmem_gather*.py``,
``aot_compile_probe.py``, ``exp_v2proto.py``, ``exp_v2_stages.py``) asked how
fast a TPU kernel can gather rows of a (14,541, 512) bf16 table by 616,448
indices, and what share of the v2 rspmm the gather was. This times G1 at
that shape in bf16 and f32, G2 at (512, 128), B1 at F=512 on the
FB15k-237-shaped graph (V=14,541, 544,230 edges, 474 relations) and G1 over
that graph's edge sources; each time beside its bound, the plain version's
and the PyTorch call's that computes the same function
(``utils/benchlib.py::gather_probe``). Each gather's output must equal its
plain version's, or the script exits 1. Needs one CUDA card; prints the
card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_gather_probe: no CUDA device", file=sys.stderr)
        return 1

    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.ops import build
    from ultra_tpu_torch.utils.benchlib import fb15k237_split, gather_probe

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    build.build_all(("gather", "rspmm_sum_fwd"))
    record = gather_probe(split_to_graph(fb15k237_split("realistic", seed=0), device="cuda"))
    record["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(record, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if not record["equal"]:
        print("torch_gather_probe: a gather differs from its plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
