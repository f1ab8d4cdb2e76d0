"""What the rspmm forwards' wrappers cost the host: the microseconds of
Python one call takes to check its operands and launch, on the card.

  python3 scripts/torch_wrapper_host_time.py [--calls 50] [--repeats 7] [--out build/wrapper_host_time.json]

The training step and an attribution call issue their launches from the
host one after another, and the card waits on them, so a wrapper's own
host time adds to those latencies once per layer. For each launch of the
main paths this times, on the host's clock, ``--calls`` calls in a row of
the wrapper with no synchronize between them (the card runs behind; the
queue never fills), ``--repeats`` times, and gives the median per call:
``rspmm_sum_fwd`` on the FB15k-237-shaped graph (seed 0) at F = 512 and
64 and on its relation graph at F = 512, ``rspmm_sum_dx`` at F = 512 and
``rspmm_minmax_fwd`` at F = 512. It takes ``ultra_tpu_torch`` from the
import path, so ``PYTHONPATH=<another checkout>`` times that checkout's
wrappers with the same script. Needs one CUDA card; prints the card's name
and power limit first, then one JSON object, which ``--out`` also writes.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def host_us(fn, calls, repeats):
    """Median over ``repeats`` of the host microseconds per call of
    ``calls`` calls of ``fn`` in a row, each run after a synchronize."""
    fn()
    samples = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - start) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(samples)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=50)
    parser.add_argument("--repeats", type=int, default=7)
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_wrapper_host_time: no CUDA device", file=sys.stderr)
        return 1

    import ultra_tpu_torch
    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_dx, rspmm_sum_fwd
    from ultra_tpu_torch.ops.rspmm_minmax_cuda import rspmm_minmax_fwd
    from ultra_tpu_torch.utils.benchlib import fb15k237_split

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    graph = split_to_graph(fb15k237_split("realistic", seed=0), device="cuda")
    rel_graph = graph.relation_graph
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=gen).cuda()
    x512, x64 = rand(graph.num_nodes, 512), rand(graph.num_nodes, 64)
    rel512, rel64 = rand(graph.num_relations, 512), rand(graph.num_relations, 64)
    rel_operands = (rand(rel_graph.num_relations, 512), rand(rel_graph.num_nodes, 512))
    w = graph.edge_weight
    launches = {
        "rspmm_sum_fwd/entity/F512": lambda: rspmm_sum_fwd(graph.csr, w, rel512, x512),
        "rspmm_sum_fwd/entity/F64": lambda: rspmm_sum_fwd(graph.csr, w, rel64, x64),
        "rspmm_sum_fwd/relation/F512": lambda: rspmm_sum_fwd(
            rel_graph.csr, rel_graph.edge_weight, *rel_operands),
        "rspmm_sum_dx/entity/F512": lambda: rspmm_sum_dx(graph.csr_src, w, rel512, x512),
        "rspmm_minmax_fwd/entity/F512": lambda: rspmm_minmax_fwd(graph.csr, w, rel512, x512),
    }
    record = {"card": card, "device": torch.cuda.get_device_name(0),
              "package": os.path.dirname(os.path.abspath(ultra_tpu_torch.__file__)),
              "calls": args.calls, "repeats": args.repeats, "host_us_per_call": {}}
    for name, fn in launches.items():
        record["host_us_per_call"][name] = host_us(fn, args.calls, args.repeats)
        print(f"[host] {name}: {record['host_us_per_call'][name]!r} us", flush=True)
    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
