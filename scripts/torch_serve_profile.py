"""Where the port's serving time goes on the card.

    python3 scripts/torch_serve_profile.py [--pna] [--out build/torch_serve_profile.json]

Needs one CUDA card. It serves the ``ultra_3g`` model, or with ``--pna`` its
PNA variant (``benchlib.pna_config``), with random weights from seed 0, on
the FB15k-237-shaped synthetic graph, as ``chip_smoke.py`` does, and
measures:

1. with ``torch.profiler``, the device time of each kernel in the relation
   precompute and in 10 warm batches of 8 tail requests, and the device's busy
   share of the wall time;
2. the sum and the max rspmm kernels (B1, B3) at the entity width
   (F = 8 x 64) on the graph and on a graph with the same sources, types and
   edge count whose destinations are drawn uniformly. Each kernel walks a
   row's edges in one block, one edge after another, so the gap between the
   two is what the graph's longest rows cost.

Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

BATCH = 8
PROFILED_BATCHES = 10


def kernel_table(prof, per: int):
    """Device ms per ``per`` runs of each kernel name, largest first, and
    their sum. Ranges that code marks on the device timeline (the
    optimizer's step) are left out: the kernels inside them are counted."""
    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = e.self_device_time_total / 1e3 / per
        if ms > 0:
            rows.append({"kernel": e.key[:120], "ms": ms, "calls": e.count / per})
    rows.sort(key=lambda r: -r["ms"])
    return rows, sum(r["ms"] for r in rows)


def profile(fn, runs: int, top: int = 12):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / runs
    kernels, busy_ms = kernel_table(prof, runs)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "kernels": kernels[:top]}


def max_in_degree(graph) -> int:
    return int(graph.csr.rowptr.diff().max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pna", action="store_true", help="profile the PNA model")
    parser.add_argument("--out", default="build/torch_serve_profile.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 1

    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.graph import make_graph
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.ops import build
    from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_fwd
    from ultra_tpu_torch.ops.rspmm_minmax_cuda import rspmm_minmax_fwd
    from ultra_tpu_torch.serve import UltraPredictor
    from ultra_tpu_torch.train.eval import precompute_relation_representations
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.utils.benchlib import device_ms, fb15k237_split, pna_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    build.build_all(("rspmm_sum_fwd", "rspmm_minmax_fwd"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    split = fb15k237_split("realistic", seed=0)
    graph = split_to_graph(split, device="cuda")
    cfg = pna_config() if args.pna else UltraConfig()
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    pred = UltraPredictor(model, graph, batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(0)
    h = rng.integers(0, split.num_nodes, BATCH)
    r = rng.integers(0, split.num_relations // 2, BATCH)

    result = {"card": card, "model": "pna" if args.pna else "ultra_3g", "graph": {
        "V": graph.num_nodes, "E": int(graph.csr.col.numel()), "R": graph.num_relations,
        "max_in_degree": max_in_degree(graph),
        "mean_in_degree": graph.csr.col.numel() / graph.num_nodes,
        "rel_graph_E": int(graph.relation_graph.csr.col.numel()),
        "rel_graph_max_in_degree": max_in_degree(graph.relation_graph)}}
    result["precompute"] = profile(
        lambda: precompute_relation_representations(pred.model, pred.graph), 1)
    torch.cuda.reset_peak_memory_stats()
    result["batch"] = profile(lambda: pred.predict_tails(h, r, k=10), PROFILED_BATCHES)
    result["batch"]["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2**20

    # B1 and B3 at the entity width: this graph vs uniformly drawn destinations
    gen = torch.Generator().manual_seed(1)
    feat = BATCH * UltraConfig().entity_model.input_dim
    x = torch.randn(graph.num_nodes, feat, generator=gen).cuda()
    rel = torch.randn(graph.num_relations, feat, generator=gen).cuda()
    edge_index = split.edge_index.copy()
    edge_index[0] = np.random.default_rng(1).integers(0, split.num_nodes, edge_index.shape[1])
    balanced = make_graph(edge_index, split.edge_type, split.num_nodes,
                          split.num_relations, device="cuda")
    result["rspmm_by_degree"] = {
        name: {"max_in_degree": max_in_degree(g),
               "ms": device_ms(lambda g=g: rspmm_sum_fwd(g.csr, g.edge_weight, rel, x, "mul")),
               "max_ms": device_ms(
                   lambda g=g: rspmm_minmax_fwd(g.csr, g.edge_weight, rel, x, "mul", False))}
        for name, g in (("graph", graph), ("uniform_destinations", balanced))
    }

    text = json.dumps(result, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
