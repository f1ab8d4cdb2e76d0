"""Time the host beam search of path interpretation on the repo's rule-KG:
the port's array version (``ultra_tpu_torch/models/visualize.py``) against
the per-node, per-edge, per-rank loop it replaces, on the same edge
gradients, and check that both give the same output.

  python3 scripts/torch_beam_search_time.py [--device cpu] [--out FILE]

The loop below is the JAX package's ``beam_search_distance``
(``ultra_tpu/models/visualize.py:134-182``), copied line for line so that
this script imports nothing of that package. The gradients are those of
``ultra_3g`` with random weights from ``--seed`` for one test triple of
``kg-datasets/synthrule-v5000-b12-c6-e45000-s3`` (272,020 message edges),
computed on ``--device`` (the card by default); both searches run on the
host. Prints one JSON record: the loop's seconds, the array version's
(median of ``--repeats``), and whether the distances and back edges are
equal.
"""

import argparse
import json
import os
import platform
import statistics
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

SYNTHRULE = dict(num_nodes=5000, num_base_rel=12, num_comp_rel=6, num_base_triples=45000,
                 seed=3)


def beam_search_loop(edge_index, edge_type, edge_grads, num_nodes, h_index, t_index,
                     num_beam=10):
    inputs = np.full((num_nodes, num_beam), -np.inf)
    inputs[h_index, 0] = 0.0
    edge_mask = edge_index[0] != t_index

    distances, back_edges = [], []
    for grad in edge_grads:
        node_in = edge_index[0][edge_mask]
        node_out = edge_index[1][edge_mask]
        relation = edge_type[edge_mask]
        g = grad[: edge_index.shape[1]][edge_mask]

        message = inputs[node_in] + g[:, None]  # (E', K)
        distance = np.full((num_nodes, num_beam), -np.inf)
        back_edge = np.zeros((num_nodes, num_beam, 4), dtype=np.int64)

        order = np.argsort(node_out, kind="stable")
        for t in np.unique(node_out):
            sel = order[np.searchsorted(node_out[order], t):
                        np.searchsorted(node_out[order], t, side="right")]
            msgs, srcs = [], []
            for e in sel:
                for kk in range(num_beam):
                    if np.isfinite(message[e, kk]):
                        msgs.append(message[e, kk])
                        srcs.append((node_in[e], node_out[e], relation[e], kk))
            if not msgs:
                continue
            msgs = np.asarray(msgs)
            srcs_arr = np.asarray(srcs)
            _, first = np.unique(srcs_arr[:, [0, 1, 2, 3]], axis=0, return_index=True)
            msgs = msgs[np.sort(first)]
            srcs_arr = srcs_arr[np.sort(first)]
            top = np.argsort(-msgs, kind="stable")[:num_beam]
            distance[t, : len(top)] = msgs[top]
            back_edge[t, : len(top)] = srcs_arr[top]

        distances.append(distance)
        back_edges.append(back_edge)
        inputs = distance
    return distances, back_edges


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--beam", type=int, default=10)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()

    from ultra_tpu_torch.data import kg
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.models.visualize import beam_search_distance, edge_gradients
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.train.runner import prepare_graph

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "kg-datasets")
    test = kg.build_dataset("SyntheticRuleKG", root, **SYNTHRULE).load().test
    graph = prepare_graph(test, device=args.device)
    model = init_ultra_params(UltraConfig(), torch.Generator().manual_seed(args.seed),
                              device=args.device)
    i = int(np.random.default_rng(args.seed).integers(test.target_edge_index.shape[1]))
    h, t, r = (int(test.target_edge_index[0, i]), int(test.target_edge_index[1, i]),
               int(test.target_edge_type[i]))
    live = graph.edge_weight.cpu().numpy() != 0
    grads = [g * live for g in edge_gradients(model, graph, h, t, r)]
    ei, et = graph.edge_index.cpu().numpy(), graph.edge_type.cpu().numpy()
    search = (ei, et, grads, graph.num_nodes, h, t, args.beam)

    array_s = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        got = beam_search_distance(*search)
        array_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = beam_search_loop(*search)
    loop_s = time.perf_counter() - t0
    equal = all(np.array_equal(a, b) for a, b in zip(got[0] + got[1], want[0] + want[1]))
    record = {"query": [h, r, t], "V": graph.num_nodes, "E": int(ei.shape[1]),
              "beam": args.beam, "loop_s": loop_s, "array_s": statistics.median(array_s),
              "array_s_all": array_s, "equal": equal, "cpus": len(os.sched_getaffinity(0)),
              "processor": platform.processor() or platform.machine()}
    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
