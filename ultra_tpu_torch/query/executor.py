"""UltraQuery's executor, the answering half: a fixed-length interpreter of
postfix query programs whose projections are ULTRA passes.

Counterpart of ``ultra_tpu/query/executor.py:1-370`` (``ultraquery.py:85-277``
of the reference). Programs arrive padded to one length and decomposed into
an op kind and an operand per slot (``query/ops.py::decompose``). The cheap
fuzzy-set operations are masked tensor operations on a (B, stack, V) stack;
a projection is one pass of the relation model (or a row of the precomputed
relation outputs) and the entity model over the whole batch:

- :func:`execute` runs slot i of every query at step i, and a projection
  pass at each slot where some query projects;
- :func:`execute_grouped` runs every query until it waits on a projection
  and batches the waiting projections into one pass, as the reference's
  deferred scheduler does (``ultraquery.py:109-133``): as many passes as
  the deepest query has projections (:func:`projection_schedule`).

The JAX package pads the round count to buckets (:func:`pad_round_schedule`)
to keep XLA's compiled programs few; a pad round is a whole pass whose
output every query ignores. The port runs eagerly and runs exactly the
rounds the batch needs; the function is kept, and a padded schedule gives
the same answers. Traversal dropout and the host symbolic machine
(``executor.py:373-725``) belong to query training, ROADMAP A10.

The stack is updated in place (the JAX package's is immutable): the
interpreter runs without autograd's record of the stack, and popped values
are copies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ultra_tpu_torch.graph import Graph
from ultra_tpu_torch.models.nbfnet import Ultra, query_nbfnet_apply, rel_nbfnet_apply
from ultra_tpu_torch.query import ops

STACK_SIZE = 2  # ultraquery.py:24


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    logic: str = "product"  # godel | product | lukasiewicz
    threshold: float = 0.0  # multi-source propagation fix (ultraquery.py:266-270)
    dropout_ratio: float = 0.25  # traversal dropout in training (ROADMAP A10)
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


def _cheap_ops(qcfg, stack, sp, k, arg, gate, num_nodes):
    """A slot's operand push, binary operation and negation for the queries
    where ``gate`` is set."""
    is_operand = gate & (k == ops.K_OPERAND)
    is_inter = gate & (k == ops.K_INTERSECTION)
    is_union = gate & (k == ops.K_UNION)
    is_neg = gate & (k == ops.K_NEGATION)

    # operand: push a one-hot (ultraquery.py:147-154)
    onehot = F.one_hot(arg.clamp(0, num_nodes - 1).long(), num_nodes).to(stack.dtype)
    stack, sp = stack_push(stack, sp, is_operand, onehot)

    # binary operations (ultraquery.py:156-182)
    is_binary = is_inter | is_union
    y, sp = stack_pop(stack, sp, is_binary)
    x, sp = stack_pop(stack, sp, is_binary)
    z = torch.where(is_inter[:, None], conjunction(qcfg.logic, x, y),
                    disjunction(qcfg.logic, x, y))
    stack, sp = stack_push(stack, sp, is_binary, z)

    # negation (ultraquery.py:184-194)
    xn, sp = stack_pop(stack, sp, is_neg)
    return stack_push(stack, sp, is_neg, negation(xn))


def _logit(t_prob):
    return torch.log((t_prob + 1e-10) / (1 - t_prob + 1e-10))


def execute(model: Ultra, qcfg: QueryConfig, graph: Graph, kind, operand, rel_reprs_all=None):
    """(B, V) logits over answer nodes (``ultraquery.py:138-144``), slot by
    slot. ``kind`` (B, L) int8 and ``operand`` (B, L) int32 as
    ``ops.decompose`` gives them, on ``graph``'s device. A slot where no
    query projects runs no pass (the host reads ``kind`` once)."""
    b, length = kind.shape
    v = graph.num_nodes
    device = graph.device
    projects = (kind == ops.K_PROJECTION).any(dim=0).tolist()  # per slot, on the host
    every = torch.ones(b, dtype=torch.bool, device=device)
    stack = torch.zeros(b, qcfg.stack_size, v, dtype=torch.float32, device=device)
    sp = torch.zeros(b, dtype=torch.int64, device=device)

    for i in range(length):
        k, arg = kind[:, i], operand[:, i]
        stack, sp = _cheap_ops(qcfg, stack, sp, k, arg, every, v)
        if projects[i]:
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


def execute_grouped(model: Ultra, qcfg: QueryConfig, graph: Graph, kind, operand, round_of,
                    has_proj, arg_slot, n_rounds: int, rel_reprs_all=None):
    """(B, V) logits like :func:`execute`, with the projections grouped into
    ``n_rounds`` passes (:func:`projection_schedule`'s arrays, on
    ``graph``'s device)."""
    b, length = kind.shape
    v = graph.num_nodes
    device = graph.device
    rows = torch.arange(b, device=device)
    stack = torch.zeros(b, qcfg.stack_size, v, dtype=torch.float32, device=device)
    sp = torch.zeros(b, dtype=torch.int64, device=device)

    for r in range(n_rounds + 1):
        for i in range(length):
            stack, sp = _cheap_ops(qcfg, stack, sp, kind[:, i], operand[:, i],
                                   round_of[:, i] == r, v)
        if r < n_rounds:
            proj = has_proj[:, r]
            r_index = operand[rows, arg_slot[:, r].long()]
            h_prob, sp = stack_pop(stack, sp, proj)
            t_prob = relation_projection(
                model, qcfg, graph, h_prob.detach(),
                r_index.clamp(0, graph.num_relations - 1).long(), rel_reprs_all=rel_reprs_all)
            stack, sp = stack_push(stack, sp, proj, t_prob)

    t_prob, sp = stack_pop(stack, sp, torch.ones(b, dtype=torch.bool, device=device))
    return _logit(t_prob)
