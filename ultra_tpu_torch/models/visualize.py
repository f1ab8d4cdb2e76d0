"""Path interpretation: the most important paths behind a prediction, by
edge gradients and a beam search over them.

Counterpart of ``ultra_tpu/models/visualize.py``. On the device,
:func:`edge_gradients` takes the gradient of one score with respect to a
separate edge-weight vector per entity layer. For ``sum`` and ``mean`` the
layers run on the rspmm kernels, and the weight gradient is kernel B6
(``ops/rspmm.py``); this is the function the JAX package differentiates
with plain XLA (``_conv_unfused``). For ``max`` and ``pna`` the layers reduce
one message per edge in plain torch (``layers.py::_per_edge_update``), as
``_conv_unfused`` does in plain XLA: their gradient shares a tie evenly
between the tying edges, as XLA's ``segment_max`` does, where the min/max
rspmm gives each tying edge the whole of it. Routing them through the min/max
rspmm would give another answer, not a faster one.

On the host, :func:`beam_search_distance` and :func:`topk_average_length`
turn the gradients into paths: the same results as the JAX package's loops,
with the per-node loop of the beam search written as array operations
(``scripts/torch_beam_search_time.py`` times both on the repo's rule-KG).
"""

from __future__ import annotations

import os
import time
from typing import List, NamedTuple

import numpy as np
import torch

from ultra_tpu_torch.graph import Graph, resolve_device
from ultra_tpu_torch.models.nbfnet import Ultra, rel_nbfnet_apply, scatter_boundary


def edge_gradients(model: Ultra, graph: Graph, h_index: int, t_index: int, r_index: int):
    """Per-layer ``d score(t | h, r) / d edge_weight``: a list of one
    (E_pad,) numpy array per entity layer, as the reference's autograd.grad
    over separate per-layer weights (``base_nbfnet.py:160-168``).

    The model's parameters are frozen for the call (and restored after), so
    autograd asks the rspmm for no relation gradient and, at the first
    layer, whose input is the boundary, for no input gradient. A slot left
    out of the graph's edge layouts (the padding) gets 0 from the sum's
    kernel where XLA gives it its derivative: :func:`visualize` masks every
    gradient by liveness."""
    device = graph.device
    entity = model.entity_model
    params = list(model.parameters())
    wanted = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        r = torch.tensor([r_index], device=device)
        with torch.no_grad():
            rel_repr = rel_nbfnet_apply(model.relation_model, graph.relation_graph, r)
        query = rel_repr[:, r_index]  # (1, D)
        boundary = scatter_boundary(torch.tensor([h_index], device=device), query,
                                    graph.num_nodes)
        weights = [graph.edge_weight.detach().clone().requires_grad_()
                   for _ in entity.layers]
        with torch.enable_grad():
            layer_input = boundary
            for conv, w in zip(entity.layers, weights):
                hidden = conv(graph.replace_weights(w), layer_input, boundary, query, rel_repr,
                              per_edge=True)
                if entity.cfg.short_cut and hidden.shape == layer_input.shape:
                    hidden = hidden + layer_input
                layer_input = hidden
            feature = torch.cat([layer_input[t_index], query], dim=-1)  # (1, F)
            score = entity.mlp(feature)[0, 0]
            grads = torch.autograd.grad(score, weights)
    finally:
        for p, want in zip(params, wanted):
            p.requires_grad_(want)
    return [g.cpu().numpy() for g in grads]


def beam_search_distance(
    edge_index: np.ndarray, edge_type: np.ndarray, edge_grads: List[np.ndarray],
    num_nodes: int, h_index: int, t_index: int, num_beam: int = 10,
):
    """Top-k path distances via per-layer beam search over edge gradients
    (``base_nbfnet.py:174-240``). Returns the per-layer ``(V, num_beam)``
    distances and ``(V, num_beam, 4)`` back edges ``(node_in, node_out,
    relation, previous rank)``.

    The JAX package visits each target node in turn and, per node, each of
    its edges in edge order and each beam rank in turn; it drops a candidate
    whose (edge endpoints, relation, rank) repeats an earlier one and keeps
    the ``num_beam`` largest, ties in visiting order. Here the candidates of
    all nodes are put in that visiting order at once, deduplicated with
    ``np.unique`` and ranked with one ``np.lexsort``: the same output."""
    inputs = np.full((num_nodes, num_beam), -np.inf)
    inputs[h_index, 0] = 0.0
    edge_mask = edge_index[0] != t_index
    node_in = edge_index[0][edge_mask]
    node_out = edge_index[1][edge_mask]
    relation = edge_type[edge_mask]
    num_relation = int(edge_type.max()) + 1 if edge_type.size else 1
    visit = np.argsort(node_out, kind="stable")  # by node, each node's edges in order

    distances, back_edges = [], []
    for grad in edge_grads:
        g = grad[: edge_index.shape[1]][edge_mask]
        message = inputs[node_in] + g[:, None]  # (E', K)
        rows, rank = np.nonzero(np.isfinite(message[visit]))  # visiting order
        edge = visit[rows]
        msgs = message[edge, rank]
        src, dst, rel = node_in[edge], node_out[edge], relation[edge]
        key = ((dst * num_nodes + src) * num_relation + rel) * num_beam + rank
        keep = np.sort(np.unique(key, return_index=True)[1])  # first of each repeat
        msgs, src, dst, rel, rank = msgs[keep], src[keep], dst[keep], rel[keep], rank[keep]
        # by node, then by descending message, ties in visiting order
        order = np.lexsort((np.arange(len(msgs)), -msgs, dst))
        place = np.arange(len(order)) - np.searchsorted(dst[order], dst[order], side="left")
        top, place = order[place < num_beam], place[place < num_beam]

        distance = np.full((num_nodes, num_beam), -np.inf)
        back_edge = np.zeros((num_nodes, num_beam, 4), dtype=np.int64)
        distance[dst[top], place] = msgs[top]
        back_edge[dst[top], place] = np.stack([src[top], dst[top], rel[top], rank[top]], axis=1)
        distances.append(distance)
        back_edges.append(back_edge)
        inputs = distance
    return distances, back_edges


def topk_average_length(distances, back_edges, t_index: int, k: int = 10):
    """Backtrack beams into explicit paths ranked by average edge gradient
    (``base_nbfnet.py:242-263``)."""
    paths, average_lengths = [], []
    for i in range(len(distances)):
        ranks = np.argsort(-distances[i][t_index], kind="stable")
        for rank in ranks[:k]:
            d = distances[i][t_index, rank]
            if not np.isfinite(d):
                break
            h, t, r, prev_rank = back_edges[i][t_index, rank]
            path = [(int(h), int(t), int(r))]
            for j in range(i - 1, -1, -1):
                h, t, r, prev_rank = back_edges[j][int(h), int(prev_rank)]
                path.append((int(h), int(t), int(r)))
            paths.append(path[::-1])
            average_lengths.append(float(d) / len(path))
    if paths:
        pairs = sorted(zip(average_lengths, paths), key=lambda x: -x[0])[:k]
        average_lengths, paths = zip(*pairs)
    return list(paths), list(average_lengths)


class Explanation(NamedTuple):
    paths: list  # each a list of (node_in, node_out, relation) hops
    weights: list  # each path's importance: its average edge gradient
    gradient_s: float  # host seconds of edge_gradients, ending with the copy to the host
    search_s: float  # host seconds of the beam search and the backtracking


def visualize(model: Ultra, graph: Graph, h_index: int, t_index: int, r_index: int,
              num_beam: int = 10, path_topk: int = 10) -> Explanation:
    """Top paths explaining score(h, r -> t) with importance weights."""
    t0 = time.perf_counter()
    grads = edge_gradients(model, graph, h_index, t_index, r_index)
    t1 = time.perf_counter()
    ei = graph.edge_index.cpu().numpy()
    et = graph.edge_type.cpu().numpy()
    live = graph.edge_weight.detach().cpu().numpy() != 0
    grads = [g * live for g in grads]
    distances, back_edges = beam_search_distance(
        ei, et, grads, graph.num_nodes, h_index, t_index, num_beam
    )
    paths, weights = topk_average_length(distances, back_edges, t_index, path_topk)
    return Explanation(paths, weights, t1 - t0, time.perf_counter() - t1)


def format_paths(explanation: Explanation, dataset: str, head: int, relation: int,
                 tail: int) -> List[str]:
    """The lines ``scripts/visualize.py`` prints: a heading, then each path
    as ``h -[r]-> x -[r']-> t  (importance w)``."""
    lines = [f"top {len(explanation.paths)} paths for ({head}, {relation}) -> {tail} on "
             f"{dataset}/test:"]
    for path, w in zip(explanation.paths, explanation.weights):
        hops = " ".join(f"-[{er}]-> {et}" for (_, et, er) in path)
        lines.append(f"  {path[0][0]} {hops}  (importance {w:.4f})")
    return lines


def visualize_from_config(cfg: dict, head: int, relation: int, tail: int, num_beam: int = 10,
                          path_topk: int = 10, device="cuda"):
    """What ``scripts/torch_visualize.py`` runs once it has read the YAML:
    load the dataset (``cfg["dataset"]``: its ``class``, ``root`` and
    constructor keys), the model (``cfg["model"]``) and its weights
    (``cfg["checkpoint"]``, a reference-layout ``.pth``), and explain
    ``(head, relation) -> tail`` on the test split's graph. Ids are the
    dataset's vocabulary ids; ``relation`` is a direct relation. Returns
    (dataset class name, :class:`Explanation`)."""
    from ultra_tpu_torch.data import kg
    from ultra_tpu_torch.train.runner import model_config_from_dict, prepare_graph
    from ultra_tpu_torch.utils.ckpt import load_model_checkpoint

    device = resolve_device(device)
    ds_cfg = dict(cfg["dataset"])
    ds_name = ds_cfg.pop("class")
    root = os.path.expanduser(ds_cfg.pop("root", "./kg-datasets"))
    dataset = kg.build_dataset(ds_name, root, **ds_cfg).load()
    ckpt = cfg.get("checkpoint")
    if not ckpt:
        raise ValueError("visualize needs a checkpoint (--ckpt)")
    model = Ultra(model_config_from_dict(cfg["model"]))
    model.load_state_dict(load_model_checkpoint(ckpt))
    model = model.to(device).eval()
    graph = prepare_graph(dataset.test, device=device)

    v, r_direct = graph.num_nodes, graph.num_relations // 2
    for name, val, hi in (("head", head, v), ("tail", tail, v), ("relation", relation, r_direct)):
        if not 0 <= val < hi:
            raise ValueError(f"--{name} {val} out of range [0, {hi})")
    return ds_name, visualize(model, graph, head, tail, relation, num_beam, path_topk)
