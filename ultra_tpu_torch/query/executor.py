"""UltraQuery's executor: a fixed-length interpreter of postfix query
programs whose projections are ULTRA passes, and the host's symbolic
machine that plans traversal dropout for training.

Counterpart of ``ultra_tpu/query/executor.py`` (``ultraquery.py:34-277`` of
the reference). Programs arrive padded to one length and decomposed into
an op kind and an operand per slot (``query/ops.py::decompose``). The cheap
fuzzy-set operations are masked tensor operations on a (B, stack, V) stack;
a projection is one pass of the relation model (or a row of the precomputed
relation outputs) and the entity model over the whole batch:

- :func:`execute` runs slot i of every query at step i, and a projection
  pass at each slot where some query projects;
- :func:`execute_grouped` runs every query until it waits on a projection
  and batches the waiting projections into one pass, as the reference's
  deferred scheduler does (``ultraquery.py:109-133``): as many passes as
  the deepest query has projections (:func:`projection_schedule`). The
  host launches each cheap op as a few small operations, so it runs only
  the (pass, slot, kind) parts where some query has one
  (:func:`cheap_schedule`).

Both take one graph, or in training one graph per slot (per round for the
grouped one): traversal dropout (``ultraquery.py:34-83``) removes edges
before each projection, and the relation graph with them. The symbolic
machine is exactly boolean, so the host runs it ahead of the step
(:func:`simulate_symbolic`, :func:`simulate_symbolic_grouped`) and turns
each projection's dropped edges into a weight mask over the graph's edges
and, through ``tasks.RelGraphMasker``, over its relation graph's edges;
:func:`graphs_for_slots` puts the masks on the base graph with
``Graph.replace_weights``, so every slot shares the base graph's layouts.
The JAX package's other route, a relation graph rebuilt with its TPU plan
each projection, has no counterpart.

The JAX package pads the round count to buckets (:func:`pad_round_schedule`)
to keep XLA's compiled programs few; a pad round is a whole pass whose
output every query ignores. The port runs eagerly and runs exactly the
rounds the batch needs; the function is kept, and a padded schedule gives
the same answers.

The stack is updated in place (the JAX package's is immutable). Under
autograd that is exact: a push records an ``index_put`` whose backward
routes each row's gradient to the value pushed, and a pop is a copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ultra_tpu_torch import tasks
from ultra_tpu_torch.graph import Graph
from ultra_tpu_torch.models.nbfnet import Ultra, query_nbfnet_apply, rel_nbfnet_apply
from ultra_tpu_torch.query import ops
from ultra_tpu_torch.utils import profiling

STACK_SIZE = 2  # ultraquery.py:24


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    logic: str = "product"  # godel | product | lukasiewicz
    threshold: float = 0.0  # multi-source propagation fix (ultraquery.py:266-270)
    dropout_ratio: float = 0.25  # traversal dropout in training
    more_dropout: float = 0.0
    stack_size: int = STACK_SIZE


def conjunction(logic: str, x, y):
    if logic == "godel":
        return torch.minimum(x, y)
    if logic == "product":
        return x * y
    if logic == "lukasiewicz":
        return (x + y - 1).clamp(min=0)
    raise ValueError(f"unknown fuzzy logic {logic!r}")


def disjunction(logic: str, x, y):
    if logic == "godel":
        return torch.maximum(x, y)
    if logic == "product":
        return x + y - x * y
    if logic == "lukasiewicz":
        return (x + y).clamp(max=1)
    raise ValueError(f"unknown fuzzy logic {logic!r}")


def negation(x):
    return 1.0 - x


# ---------------------------------------------------------------------------
# the masked batched stack (query_utils.py:198-235)
# ---------------------------------------------------------------------------


def stack_push(stack, sp, mask, value):
    """Push ``value`` (B, V) onto each query's stack where ``mask`` (B,) is
    set; stack (B, S, V), pointers ``sp`` (B,). The slot is the clipped
    pointer and the write keeps the old row where ``mask`` is unset, so a
    query whose pointer is clipped never overwrites the other operand.
    Writes ``stack`` in place; returns it and the new pointers."""
    rows = torch.arange(stack.shape[0], device=stack.device)
    idx = sp.clamp(0, stack.shape[1] - 1)
    stack[rows, idx] = torch.where(mask[:, None], value, stack[rows, idx])
    return stack, torch.where(mask, sp + 1, sp)


def stack_pop(stack, sp, mask):
    """(the top row of each query's stack (a copy), the pointers moved down
    where ``mask`` is set)."""
    rows = torch.arange(stack.shape[0], device=stack.device)
    value = stack[rows, (sp - 1).clamp(0, stack.shape[1] - 1)]
    return value, torch.where(mask, sp - 1, sp)


# ---------------------------------------------------------------------------
# relation projection (ultraquery.py:245-277)
# ---------------------------------------------------------------------------


def relation_projection(model: Ultra, qcfg: QueryConfig, graph: Graph, h_prob, r_index,
                        rel_reprs_all=None):
    """One hop: a (B, V) fuzzy set and (B,) relations -> a (B, V) fuzzy set.

    ``rel_reprs_all`` (R, R, D), in evaluation: the relation model's
    outputs for every query relation (``train/eval.py::
    precompute_relation_representations``), so no projection runs the
    relation model."""
    b = r_index.shape[0]
    if rel_reprs_all is not None:
        rel_reprs = rel_reprs_all[r_index]  # (B, R, D)
    else:
        rel_reprs = rel_nbfnet_apply(model.relation_model, graph.relation_graph, r_index)
    query = rel_reprs[torch.arange(b, device=r_index.device), r_index]  # (B, D)
    if qcfg.threshold > 0.0:
        h_prob = torch.where(h_prob > qcfg.threshold, h_prob, 0.0)
    # node-major boundary: (V, B, D) = h_prob^T outer query
    node_features = h_prob.T[:, :, None] * query[None, :, :]
    output = query_nbfnet_apply(model.entity_model, graph, node_features, rel_reprs, query)
    return torch.sigmoid(output)


CHEAP_KINDS = frozenset((ops.K_OPERAND, ops.K_INTERSECTION, ops.K_UNION, ops.K_NEGATION))


def _cheap_ops(qcfg, stack, sp, k, arg, gate, num_nodes, kinds=CHEAP_KINDS):
    """A slot's operand push, binary operation and negation for the queries
    where ``gate`` is set. ``kinds``: the op kinds that some gated query
    has at this slot; the parts for the others run under an empty gate,
    which leaves the stack and the pointers as they were, and are skipped."""
    if ops.K_OPERAND in kinds:
        # operand: push a one-hot (ultraquery.py:147-154)
        is_operand = gate & (k == ops.K_OPERAND)
        onehot = F.one_hot(arg.clamp(0, num_nodes - 1).long(), num_nodes).to(stack.dtype)
        stack, sp = stack_push(stack, sp, is_operand, onehot)

    if ops.K_INTERSECTION in kinds or ops.K_UNION in kinds:
        # binary operations (ultraquery.py:156-182)
        is_inter = gate & (k == ops.K_INTERSECTION)
        is_binary = is_inter | (gate & (k == ops.K_UNION))
        y, sp = stack_pop(stack, sp, is_binary)
        x, sp = stack_pop(stack, sp, is_binary)
        z = torch.where(is_inter[:, None], conjunction(qcfg.logic, x, y),
                        disjunction(qcfg.logic, x, y))
        stack, sp = stack_push(stack, sp, is_binary, z)

    if ops.K_NEGATION in kinds:
        # negation (ultraquery.py:184-194)
        is_neg = gate & (k == ops.K_NEGATION)
        xn, sp = stack_pop(stack, sp, is_neg)
        stack, sp = stack_push(stack, sp, is_neg, negation(xn))
    return stack, sp


def _logit(t_prob):
    return torch.log((t_prob + 1e-10) / (1 - t_prob + 1e-10))


def _graph_lookup(graphs: Union[Graph, Sequence[Graph]], rel_reprs_all):
    """``graphs`` as a function of the slot or round, and the first graph.
    The relation cache holds the relation model's outputs on one graph, so
    it goes with one graph only."""
    if isinstance(graphs, Graph):
        return (lambda i: graphs), graphs
    assert rel_reprs_all is None, "relation cache requires a single shared graph"
    return graphs.__getitem__, graphs[0]


def execute(model: Ultra, qcfg: QueryConfig, graphs: Union[Graph, Sequence[Graph]], kind,
            operand, rel_reprs_all=None):
    """(B, V) logits over answer nodes (``ultraquery.py:138-144``), slot by
    slot. ``kind`` (B, L) int8 and ``operand`` (B, L) int32 as
    ``ops.decompose`` gives them, on the graphs' device. ``graphs`` is one
    graph, or one per slot (:func:`graphs_for_slots`; a projection then
    runs the relation model on its slot's relation graph). A slot where no
    query projects runs no pass (the host reads ``kind`` once)."""
    graph_at, first = _graph_lookup(graphs, rel_reprs_all)
    b, length = kind.shape
    v = first.num_nodes
    device = first.device
    projects = (kind == ops.K_PROJECTION).any(dim=0).tolist()  # per slot, on the host
    every = torch.ones(b, dtype=torch.bool, device=device)
    stack = torch.zeros(b, qcfg.stack_size, v, dtype=torch.float32, device=device)
    sp = torch.zeros(b, dtype=torch.int64, device=device)

    for i in range(length):
        k, arg = kind[:, i], operand[:, i]
        stack, sp = _cheap_ops(qcfg, stack, sp, k, arg, every, v)
        if projects[i]:
            graph = graph_at(i)
            is_proj = k == ops.K_PROJECTION
            h_prob, sp = stack_pop(stack, sp, is_proj)
            t_prob = relation_projection(
                model, qcfg, graph, h_prob.detach(),  # detach (ultraquery.py:209)
                arg.clamp(0, graph.num_relations - 1).long(), rel_reprs_all=rel_reprs_all)
            stack, sp = stack_push(stack, sp, is_proj, t_prob)

    t_prob, sp = stack_pop(stack, sp, every)
    return _logit(t_prob)


# ---------------------------------------------------------------------------
# the round-grouped executor: projections batched across program positions
# ---------------------------------------------------------------------------


# The JAX package's round buckets: each n_rounds is one compiled program
# there, so deeper programs round up to the next bucket. BetaE's types have
# at most 3 projections, so (1, 2, 3) never pad.
ROUND_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16)


def bucket_rounds(n_rounds: int) -> int:
    """Smallest ROUND_BUCKETS entry >= n_rounds (n_rounds itself beyond)."""
    for b in ROUND_BUCKETS:
        if n_rounds <= b:
            return b
    return n_rounds


def pad_round_schedule(has_proj, arg_slot, n_rounds: int, round_graphs=None):
    """Pad a projection_schedule to its round bucket. Pad rounds have
    has_proj all-False (their pass runs but every query's pop and push is
    masked off) and, for training, repeat the last round graph. Returns
    (has_proj, arg_slot, n_bucket, round_graphs_or_None)."""
    nb = bucket_rounds(n_rounds) if n_rounds else 0
    if nb == n_rounds:
        return has_proj, arg_slot, n_rounds, round_graphs
    b = has_proj.shape[0]
    pad = nb - n_rounds
    has_proj = np.concatenate([np.asarray(has_proj), np.zeros((b, pad), bool)], axis=1)
    arg_slot = np.concatenate([np.asarray(arg_slot), np.zeros((b, pad), np.int32)], axis=1)
    if round_graphs is not None:
        round_graphs = list(round_graphs) + [round_graphs[-1]] * pad
    return has_proj, arg_slot, nb, round_graphs


def projection_schedule(kind: np.ndarray):
    """The host's schedule for :func:`execute_grouped`.

    ``round_of[b, i]`` = the number of projection slots before slot i in
    query b. The cheap slots with ``round_of == r`` sit between projections
    r-1 and r and run in round r's cheap pass; the projection slot with
    ``round_of == r`` is round r's projection, and every query's round-r
    projection runs in one pass.

    Returns (round_of (B, L) int32, has_proj (B, R) bool, arg_slot (B, R)
    int32, the slot of each round's projection, n_rounds)."""
    kindn = np.asarray(kind)
    is_proj = kindn == ops.K_PROJECTION
    round_of = (np.cumsum(is_proj, axis=1) - is_proj).astype(np.int32)
    n_rounds = int(is_proj.sum(axis=1).max()) if kindn.size else 0
    b = kindn.shape[0]
    has_proj = np.zeros((b, n_rounds), bool)
    arg_slot = np.zeros((b, n_rounds), np.int64)
    rows, slots = np.nonzero(is_proj)
    has_proj[rows, round_of[rows, slots]] = True
    arg_slot[rows, round_of[rows, slots]] = slots
    return round_of, has_proj, arg_slot.astype(np.int32), n_rounds


def cheap_schedule(kind: np.ndarray, round_of: np.ndarray, n_rounds: int):
    """The host's plan of :func:`execute_grouped`'s n_rounds + 1 cheap
    passes: for each, the (slot, op kinds) of every slot at which some query
    has a cheap op (operand, intersection, union, negation) in that pass,
    with the kinds present there. Every other (pass, slot), and every part
    of a slot for a kind absent from it, runs under an empty gate, which
    leaves the stack as it was: the plan skips them, and the logits and
    their gradients are those of every slot run."""
    kindn, roundn = np.asarray(kind), np.asarray(round_of)
    cheap = np.isin(kindn, sorted(CHEAP_KINDS))
    plan = []
    for r in range(n_rounds + 1):
        here = cheap & (roundn == r)
        plan.append([(int(i), frozenset(kindn[here[:, i], i].tolist()))
                     for i in np.flatnonzero(here.any(axis=0))])
    return plan


def execute_grouped(model: Ultra, qcfg: QueryConfig, graphs: Union[Graph, Sequence[Graph]],
                    kind, operand, round_of, has_proj, arg_slot, n_rounds: int,
                    rel_reprs_all=None, cheap=None):
    """(B, V) logits like :func:`execute`, with the projections grouped into
    ``n_rounds`` passes (:func:`projection_schedule`'s arrays, on the
    graphs' device). ``graphs`` is one graph, or in training one per round
    (:func:`simulate_symbolic_grouped`: one dropout mask a round for the
    whole batch, the reference's own granularity, ``ultraquery.py:196-203``).
    ``cheap``: :func:`cheap_schedule` of the batch, which the host reads
    from ``kind`` and ``round_of``; without it every slot runs every cheap
    op in every pass (the plain interpreter, which the tests compare with).

    Under a profiler each round records the span ``ultra.query.cheap`` (its
    cheap-op slots, which the host launches one small operation at a time)
    and ``ultra.query.project`` (its projection pass), as
    ``utils/profiling.py::annotate`` records."""
    graph_at, first = _graph_lookup(graphs, rel_reprs_all)
    b, length = kind.shape
    v = first.num_nodes
    device = first.device
    rows = torch.arange(b, device=device)
    stack = torch.zeros(b, qcfg.stack_size, v, dtype=torch.float32, device=device)
    sp = torch.zeros(b, dtype=torch.int64, device=device)

    for r in range(n_rounds + 1):
        with profiling.annotate("ultra.query.cheap"):
            slots = [(i, CHEAP_KINDS) for i in range(length)] if cheap is None else cheap[r]
            for i, kinds in slots:
                stack, sp = _cheap_ops(qcfg, stack, sp, kind[:, i], operand[:, i],
                                       round_of[:, i] == r, v, kinds)
        if r < n_rounds:
            with profiling.annotate("ultra.query.project"):
                graph = graph_at(r)
                proj = has_proj[:, r]
                r_index = operand[rows, arg_slot[:, r].long()]
                h_prob, sp = stack_pop(stack, sp, proj)
                t_prob = relation_projection(
                    model, qcfg, graph, h_prob.detach(),
                    r_index.clamp(0, graph.num_relations - 1).long(),
                    rel_reprs_all=rel_reprs_all)
                stack, sp = stack_push(stack, sp, proj, t_prob)

    t_prob, sp = stack_pop(stack, sp, torch.ones(b, dtype=torch.bool, device=device))
    return _logit(t_prob)


# ---------------------------------------------------------------------------
# the host's symbolic machine and traversal dropout (training)
# ---------------------------------------------------------------------------


def symbolic_traversal_host(h_sets, r_index, edge_index, edge_type, live):
    """Boolean traversal: t is in out[b] when a live edge (h -> t) of type
    r_index[b] leaves a node h of h_sets[b] (``ultraquery.py:281-298``)."""
    b, v = h_sets.shape
    out = np.zeros_like(h_sets)
    for i in range(b):
        mask = live & (edge_type == r_index[i]) & h_sets[i, edge_index[0]]
        out[i, edge_index[1][mask]] = True
    return out


def traversal_dropout_host(
    h_sets, r_index, edge_index, edge_type, live, num_relations,
    rng, dropout_ratio, more_dropout=0.0, inverse_rel_plus_one=False,
    matchers=None, degrees=None,
):
    """The ids of the edges one projection drops (``ultraquery.py:34-83``):
    each edge the projection would traverse from its sets, and its inverse,
    drops with probability ``dropout_ratio`` unless an endpoint has degree
    1 or less; ``more_dropout`` drops other edges at random by the same
    rule. ``matchers`` and ``degrees``: the :class:`DropoutPlanner`'s tables
    of the base graph (built here when not given)."""
    sample, h_index = np.nonzero(h_sets)
    r = np.asarray(r_index)[sample]
    if matchers is None:
        matcher_d = tasks.EdgeMatcher(np.stack([edge_index[0], edge_type]).astype(np.int64))
        matcher_i = tasks.EdgeMatcher(np.stack([edge_type, edge_index[1]]).astype(np.int64))
    else:
        matcher_d, matcher_i = matchers
    direct_ids, _ = matcher_d.query(np.stack([h_index, r]))
    if inverse_rel_plus_one:
        inv_r = r ^ 1
    else:
        half = num_relations // 2
        inv_r = np.where(r >= half, r - half, r + half)
    inverse_ids, _ = matcher_i.query(np.stack([inv_r, h_index]))

    ids = np.concatenate([direct_ids, inverse_ids])
    ids = ids[live[ids]]
    # never drop an edge with an endpoint of degree <= 1 (ultraquery.py:56-62)
    if degrees is None:
        deg_h = np.bincount(edge_index[0], weights=live.astype(np.int64),
                            minlength=h_sets.shape[1])
        deg_t = np.bincount(edge_index[1], weights=live.astype(np.int64),
                            minlength=h_sets.shape[1])
    else:
        deg_h, deg_t = degrees
    must_keep = (deg_h[edge_index[0, ids]] <= 1) | (deg_t[edge_index[1, ids]] <= 1)
    ids = ids[~must_keep]
    ids = ids[rng.random(len(ids)) <= dropout_ratio]
    if more_dropout > 0.0:
        more = np.nonzero(rng.random(edge_index.shape[1]) <= more_dropout)[0]
        keep = (deg_h[edge_index[0, more]] <= 1) | (deg_t[edge_index[1, more]] <= 1)
        ids = np.unique(np.concatenate([ids, more[~keep]]))
    return ids


class DropoutPlanner:
    """What traversal dropout needs of the base graph, built once: dropout
    starts from the base graph's edges every projection
    (``ultraquery.py:196-203``), so the edge matchers and the endpoint
    degrees of :func:`traversal_dropout_host`, and the
    ``tasks.RelGraphMasker`` that turns a projection's dropped edges into a
    mask over the base relation graph, are the same for every projection.

    ``graph_host``: the base graph's host arrays (``edge_index``,
    ``edge_type``, ``num_nodes``, ``num_relations``). ``rel_edge_index``
    and ``rel_edge_type`` must be the base relation graph's edges in its
    order (by default ``tasks.build_relation_graph_arrays`` of the edges,
    as ``query/trainer.py::prepare_query_graph`` builds it)."""

    def __init__(self, graph_host: dict, rel_edge_index=None, rel_edge_type=None):
        ei = np.asarray(graph_host["edge_index"])
        et = np.asarray(graph_host["edge_type"])
        v = graph_host["num_nodes"]
        self.matchers = (
            tasks.EdgeMatcher(np.stack([ei[0], et]).astype(np.int64)),
            tasks.EdgeMatcher(np.stack([et, ei[1]]).astype(np.int64)),
        )
        self.degrees = (np.bincount(ei[0], minlength=v), np.bincount(ei[1], minlength=v))
        self.masker = tasks.RelGraphMasker(ei, et, v, graph_host["num_relations"],
                                           rel_edge_index, rel_edge_type)


class SymbolicPlan:
    """Each slot's (or round's) edge weights over the graph's edges and its
    relation graph's, host arrays; None at a slot where no query projects."""

    def __init__(self, slot_weights: List[Optional[np.ndarray]],
                 slot_rel_graphs: List[Optional[np.ndarray]]):
        self.slot_weights = slot_weights
        self.slot_rel_graphs = slot_rel_graphs


class _BoolStack:
    """The symbolic machine's stack of boolean sets: (B, S, V) with the
    executor's clipped pointer."""

    def __init__(self, b, stack_size, v):
        self.stack = np.zeros((b, stack_size, v), dtype=bool)
        self.sp = np.zeros(b, dtype=np.int64)

    def push(self, mask, val):
        self.stack[mask, self.sp[mask]] = val[mask]
        self.sp[mask] += 1

    def pop(self, mask):
        self.sp[mask] -= 1
        b, size = self.stack.shape[:2]
        return self.stack[np.arange(b), np.clip(self.sp, 0, size - 1)]

    def cheap_ops(self, k, arg, gate, v):
        """A slot's operand push, binary operation and negation where
        ``gate`` is set."""
        b = len(k)
        is_operand = gate & (k == ops.K_OPERAND)
        is_inter = gate & (k == ops.K_INTERSECTION)
        is_union = gate & (k == ops.K_UNION)
        is_neg = gate & (k == ops.K_NEGATION)
        if is_operand.any():
            onehot = np.zeros((b, v), dtype=bool)
            onehot[np.arange(b), np.clip(arg, 0, v - 1)] = True
            self.push(is_operand, onehot)
        binary = is_inter | is_union
        if binary.any():
            y = self.pop(binary)
            x = self.pop(binary)
            self.push(binary, np.where(is_inter[:, None], x & y, x | y))
        if is_neg.any():
            self.push(is_neg, ~self.pop(is_neg))


def _project(stack, proj, r_index, graph_host, qcfg, rng, planner, training):
    """One projection of the symbolic machine for the queries ``proj``:
    dropout from the base graph, the traversal, the push. Returns (the
    edge weights (E_pad,), the relation graph's weights (M,))."""
    edge_index = np.asarray(graph_host["edge_index"])
    edge_type = np.asarray(graph_host["edge_type"])
    e = edge_index.shape[1]
    h_sets = stack.pop(proj).copy()
    h_sets[~proj] = False
    live = np.ones(e, dtype=bool)
    drop = np.zeros(0, dtype=np.int64)
    if training and qcfg.dropout_ratio > 0:
        drop = traversal_dropout_host(
            h_sets[proj], r_index[proj], edge_index, edge_type, live,
            graph_host["num_relations"], rng, qcfg.dropout_ratio, qcfg.more_dropout,
            graph_host.get("inverse_rel_plus_one", False),
            matchers=planner.matchers, degrees=planner.degrees)
        live[drop] = False
    stack.push(proj, symbolic_traversal_host(h_sets, r_index, edge_index, edge_type, live))
    w = np.zeros(graph_host.get("e_pad", e), dtype=np.float32)
    w[:e][live] = 1.0
    return w, planner.masker.edge_weights(drop)


def simulate_symbolic(kind: np.ndarray, operand: np.ndarray, graph_host: dict,
                      qcfg: QueryConfig, rng: np.random.Generator, training: bool = True,
                      planner: Optional[DropoutPlanner] = None) -> SymbolicPlan:
    """Run the boolean stack machine slot by slot on the host, with
    traversal dropout before each projection slot (in ``training``): the
    :class:`SymbolicPlan` of :func:`execute`'s slots. Dropout at each slot
    starts from the base graph's edges, not from the last slot's.

    ``graph_host``: the base graph's host arrays (``edge_index``,
    ``edge_type``, ``num_nodes``, ``num_relations``,
    ``inverse_rel_plus_one``, and ``e_pad``, the graph's padded edge count,
    by default its edges'). ``planner`` (built here when not given) is the
    base graph's :class:`DropoutPlanner`."""
    planner = planner or DropoutPlanner(graph_host)
    v = graph_host["num_nodes"]
    b, length = kind.shape
    stack = _BoolStack(b, qcfg.stack_size, v)
    every = np.ones(b, dtype=bool)
    slot_weights, slot_rel = [], []
    for i in range(length):
        k, arg = kind[:, i], operand[:, i]
        stack.cheap_ops(k, arg, every, v)
        is_proj = k == ops.K_PROJECTION
        if is_proj.any():
            w, rel_w = _project(stack, is_proj, arg, graph_host, qcfg, rng, planner, training)
        else:
            w = rel_w = None
        slot_weights.append(w)
        slot_rel.append(rel_w)
    return SymbolicPlan(slot_weights, slot_rel)


def simulate_symbolic_grouped(kind: np.ndarray, operand: np.ndarray, round_of: np.ndarray,
                              has_proj: np.ndarray, arg_slot: np.ndarray, n_rounds: int,
                              graph_host: dict, qcfg: QueryConfig, rng: np.random.Generator,
                              planner: DropoutPlanner) -> SymbolicPlan:
    """The round-grouped twin of :func:`simulate_symbolic`: one dropout mask
    a projection round, from the union of that round's projecting queries'
    sets, as the reference drops edges once a round for the whole batch
    (``ultraquery.py:196-203``). The plan has one entry a round (n_rounds),
    for :func:`execute_grouped`'s per-round graphs."""
    v = graph_host["num_nodes"]
    b, length = kind.shape
    stack = _BoolStack(b, qcfg.stack_size, v)
    round_weights, round_rel = [], []
    for r in range(n_rounds + 1):
        for i in range(length):
            stack.cheap_ops(kind[:, i], operand[:, i], round_of[:, i] == r, v)
        if r < n_rounds:
            r_index = operand[np.arange(b), arg_slot[:, r]]
            w, rel_w = _project(stack, has_proj[:, r], r_index, graph_host, qcfg, rng,
                                planner, True)
            round_weights.append(w)
            round_rel.append(rel_w)
    return SymbolicPlan(round_weights, round_rel)


def graphs_for_slots(base_graph: Graph, plan: SymbolicPlan) -> List[Graph]:
    """The per-slot (or per-round) graphs of ``plan``: ``base_graph`` under
    each entry's edge weights, with its relation graph under that entry's
    relation-graph weights (``Graph.replace_weights``: the layouts of both
    are the base graph's), ``base_graph`` itself where an entry is None.
    The weights reach the device in one copy for each graph."""
    rel_base = base_graph.relation_graph
    live = [i for i, w in enumerate(plan.slot_weights) if w is not None]
    out: List[Graph] = [base_graph] * len(plan.slot_weights)
    if not live:
        return out
    m_pad = rel_base.num_edges_padded
    ew = torch.as_tensor(np.stack([plan.slot_weights[i] for i in live]),
                         device=base_graph.device)
    rel_ew = torch.as_tensor(
        np.stack([np.pad(plan.slot_rel_graphs[i], (0, m_pad - len(plan.slot_rel_graphs[i])))
                  for i in live]), device=base_graph.device)
    for j, i in enumerate(live):
        out[i] = dataclasses.replace(base_graph.replace_weights(ew[j]),
                                     relation_graph=rel_base.replace_weights(rel_ew[j]))
    return out
