"""Where the port's training step time goes on the card.

    python3 scripts/torch_train_profile.py [--pna] [--out build/torch_train_profile.json]
    python3 scripts/torch_train_profile.py --query per-slot|grouped|grouped-accum2

Needs one CUDA card. It fine-tunes the ``ultra_3g`` model, or with ``--pna``
its PNA variant (``benchlib.pna_config``), with random weights from seed 0,
on the FB15k-237-shaped synthetic graph as ``chip_smoke.py`` does
(batch 8, 256 strict negatives, easy-edge masks, AdamW) and measures, with
``torch.profiler`` over 5 warm steps, the device time of each kernel per
step and the device's busy share of the wall time; and, as the profiler
slows the host, the wall time of 5 more steps without it. The batches are
sampled and copied to the card before either window, so a window holds the
step alone: forward, backward and the AdamW update.

``--query`` profiles an UltraQuery train step instead, at ``ultra_3g``
width on the repo's BetaE set (``query-datasets-synth-held``, batch 8 of its
training queries, traversal dropout 0.25, threshold 0.8): per slot, grouped
into rounds, or grouped with grad_accum 2. Each batch's dropout plan and its
graphs are made before the windows too.

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
    parser.add_argument("--query", choices=("per-slot", "grouped", "grouped-accum2"),
                        help="profile an UltraQuery train step of this kind")
    parser.add_argument("--out", default="build/torch_train_profile.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1

    from scripts.torch_serve_profile import profile
    from ultra_tpu_torch.ops import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    build.build_all(("rspmm_sum_fwd", "rspmm_sum_drel", "rspmm_minmax_fwd", "rspmm_minmax_dx",
                     "rspmm_minmax_drel"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.query:
        result, step_fn = query_step(args.query, card)
    else:
        result, step_fn = link_prediction_step(args.pna, card)
    result["step"] = profile(step_fn, PROFILED_STEPS, top=24)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILED_STEPS):
        step_fn()
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


def query_step(kind_name, card):
    """(the record's head, a function that takes the next warm step) of an
    UltraQuery train step of ``kind_name``; WARM_STEPS steps are taken."""
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.datasets import build_query_dataset
    from ultra_tpu_torch.query.executor import (
        QueryConfig, graphs_for_slots, projection_schedule, simulate_symbolic,
        simulate_symbolic_grouped,
    )
    from ultra_tpu_torch.query.trainer import (
        answers_to_mask, dropout_planner, graph_host, make_grouped_query_train_step,
        make_query_train_step, prepare_query_graph,
    )
    from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "query-datasets-synth-held")
    dataset = build_query_dataset("FB15k237LogicalQuery", root).load()
    graph = prepare_query_graph(dataset.graphs[0], device="cuda")
    host = graph_host(dataset.graphs[0], graph)
    planner = dropout_planner(host, graph)
    qcfg = QueryConfig(threshold=0.8, dropout_ratio=0.25)
    grouped, accum = kind_name != "per-slot", 2 if kind_name == "grouped-accum2" else 1
    step = (make_grouped_query_train_step(qcfg, 0.2, grad_accum=accum) if grouped
            else make_query_train_step(qcfg, 0.2))
    rng = np.random.default_rng(1)
    lo, hi = dataset.split_ranges()[0]
    batches, passes = [], []
    for _ in range(WARM_STEPS + 1 + 2 * PROFILED_STEPS):
        take = rng.choice(np.arange(lo, hi), BATCH, replace=False)
        kind, operand = ops.decompose(dataset.queries[take])
        if grouped:
            plan = simulate_symbolic_grouped(kind, operand, *projection_schedule(kind), host,
                                             qcfg, rng, planner)
        else:
            plan = simulate_symbolic(kind, operand, host, qcfg, rng, planner=planner)
        target = answers_to_mask([dataset.easy_answers[i] for i in take],
                                 graph.num_nodes).astype(np.float32)
        batches.append((graphs_for_slots(graph, plan), kind, operand, target))
        passes.append(sum(w is not None for w in plan.slot_weights))
    model = init_ultra_params(UltraConfig(), torch.Generator().manual_seed(0), device="cuda")
    state = init_train_state(model, lr=5e-4, weight_decay=0.01)
    queue = iter(batches)
    for _ in range(WARM_STEPS):
        step(state, *next(queue))
    head = {"card": card, "model": "ultra_3g", "query_step": kind_name, "batch": BATCH,
            "graph": {"V": graph.num_nodes, "E": int(graph.csr.col.numel()),
                      "R": graph.num_relations,
                      "rel_graph_E": int(graph.relation_graph.csr.col.numel())},
            "dropout_graphs_per_batch": passes}
    return head, lambda: step(state, *next(queue))


def link_prediction_step(pna, card):
    """(the record's head, a function that takes the next warm step) of the
    fine-tuning step; WARM_STEPS steps are taken."""
    from ultra_tpu_torch import tasks
    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params, make_train_step
    from ultra_tpu_torch.train.runner import triples_of
    from ultra_tpu_torch.utils.benchlib import fb15k237_split, pna_config

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

    cfg = pna_config() if pna else UltraConfig()
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    state = init_train_state(model, lr=5e-4, weight_decay=0.01)
    step = make_train_step(adversarial_temperature=1.0, num_negative=NUM_NEGATIVE)
    for b in batches[:WARM_STEPS]:
        step(state, graph, *b)
    queue = iter(batches[WARM_STEPS:])  # profile() runs one step before its window

    result = {"card": card, "model": "pna" if pna else "ultra_3g", "batch": BATCH,
              "num_negative": NUM_NEGATIVE,
              "graph": {"V": graph.num_nodes, "E": int(graph.csr.col.numel()),
                        "R": graph.num_relations,
                        "max_in_degree": int(graph.csr.rowptr.diff().max()),
                        "max_out_degree": int(graph.csr_src.rowptr.diff().max()),
                        "largest_type_edges": int(torch.bincount(
                            graph.segments.etype.long()).max()),
                        "segment_piece_len": graph.segments.piece_len,
                        "segment_pieces": graph.segments.piece_row.numel(),
                        "rel_graph_E": int(graph.relation_graph.csr.col.numel()),
                        "rel_graph_segment_piece_len": graph.relation_graph.segments.piece_len,
                        "rel_graph_segment_pieces": (
                            graph.relation_graph.segments.piece_row.numel())}}
    return result, lambda: step(state, graph, *next(queue))


if __name__ == "__main__":
    sys.exit(main())
