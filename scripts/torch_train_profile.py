"""Where the port's fine-tuning step time goes on the card.

    python3 scripts/torch_train_profile.py [--pna] [--out build/torch_train_profile.json]

Needs one CUDA card. It fine-tunes the ``ultra_3g`` model, or with ``--pna``
its PNA variant (``benchlib.pna_config``), with random weights from seed 0,
on the FB15k-237-shaped synthetic graph as ``chip_smoke.py`` does
(batch 8, 256 strict negatives, easy-edge masks, AdamW) and measures, with
``torch.profiler`` over 5 warm steps, the device time of each kernel per
step and the device's busy share of the wall time; and, as the profiler
slows the host, the wall time of 5 more steps without it. The batches are
sampled and copied to the card before either window, so a window holds the
step alone: forward, backward and the AdamW update.

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

BATCH, NUM_NEGATIVE = 8, 256
WARM_STEPS, PROFILED_STEPS = 3, 5


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pna", action="store_true", help="profile the PNA model")
    parser.add_argument("--out", default="build/torch_train_profile.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1

    from scripts.torch_serve_profile import profile
    from ultra_tpu_torch import tasks
    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.ops import build
    from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params, make_train_step
    from ultra_tpu_torch.train.runner import triples_of
    from ultra_tpu_torch.utils.benchlib import fb15k237_split, pna_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    build.build_all(("rspmm_sum_fwd", "rspmm_sum_drel", "rspmm_minmax_fwd", "rspmm_minmax_dx",
                     "rspmm_minmax_drel"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    split = fb15k237_split("realistic", seed=0)
    graph = split_to_graph(split, device="cuda")
    index = tasks.GraphIndex.build(split.edge_index, split.edge_type, split.num_nodes,
                                   split.num_relations)
    triples = triples_of(split)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(WARM_STEPS + 1 + 2 * PROFILED_STEPS):
        pos = triples[rng.choice(len(triples), BATCH, replace=False)]
        batch = tasks.negative_sampling(index, pos, NUM_NEGATIVE, strict=True, rng=rng)
        ew = tasks.easy_edge_weights(index, batch, graph.num_edges_padded)
        batches.append((torch.as_tensor(batch, device="cuda"),
                        torch.as_tensor(ew, device="cuda")))

    cfg = pna_config() if args.pna else UltraConfig()
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    state = init_train_state(model, lr=5e-4, weight_decay=0.01)
    step = make_train_step(adversarial_temperature=1.0, num_negative=NUM_NEGATIVE)
    for b in batches[:WARM_STEPS]:
        step(state, graph, *b)
    queue = iter(batches[WARM_STEPS:])  # profile() runs one step before its window

    result = {"card": card, "model": "pna" if args.pna else "ultra_3g", "batch": BATCH,
              "num_negative": NUM_NEGATIVE,
              "graph": {"V": graph.num_nodes, "E": int(graph.csr.col.numel()),
                        "R": graph.num_relations,
                        "max_in_degree": int(graph.csr.rowptr.diff().max()),
                        "max_out_degree": int(graph.csr_src.rowptr.diff().max()),
                        "largest_type_edges": int(torch.bincount(
                            graph.segments.etype.long()).max()),
                        "chunks": int(graph.segments.chunkptr.numel() - 1),
                        "rel_graph_E": int(graph.relation_graph.csr.col.numel()),
                        "rel_graph_chunks": int(
                            graph.relation_graph.segments.chunkptr.numel() - 1)}}
    result["step"] = profile(lambda: step(state, graph, *next(queue)), PROFILED_STEPS, top=24)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in queue:
        step(state, graph, *b)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / PROFILED_STEPS
    result["step"]["wall_ms_unprofiled"] = wall_ms
    result["step"]["device_idle_share_unprofiled"] = 1.0 - result["step"]["device_busy_ms"] / wall_ms
    result["step"]["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2**20

    text = json.dumps(result, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
