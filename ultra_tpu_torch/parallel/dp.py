"""Data parallelism over a batch's rows and edge sharding of the graph: the
train and score steps, and the two autograd Functions that combine an edge
shard's partial aggregates.

Counterpart of ``ultra_tpu/parallel/dp.py`` (``make_sharded_train_step``
:57, ``make_sharded_score_step`` :140). A rank runs the single-process step
(``train/loop.py::make_train_step``) on its rows of the global batch and its
block of the edges (``parallel/mesh.py::shard_graph``); after the backward,
one all-reduce over the data group averages the gradients and the loss (the
JAX package's ``pmean`` of the loss), and each rank applies the same AdamW
update.

The gradient under edge sharding. The ranks of an edge group hold the same
parameters, node states and rows, and each a block of the edges. A conv
combines its blocks' partial aggregates with an all-reduce
(:func:`combine_shards`): SUM for sum and PNA's sums and for the degree,
MAX and MIN for max and PNA's extremes. Downstream of the combine every rank
computes the same loss, so the gradient reaching the combine is already
whole on each rank, and its backward passes it on unchanged: to each shard
for a SUM, and for MAX or MIN to each shard whose partial equals the
combined value (``ultra_tpu/models/layers.py::_pextreme_bwd``), whose
kernels then give it to each tying edge. A shard's backward yields the
gradients of the node states and the relation features from its own edges
only; where they enter the shard (:func:`enter_shard`, the identity
forward), the backward sums them over the group. ``torch.distributed.nn``'s
autograd all-reduce sums in both directions, which would count every
replicated layer's gradient ``edge`` times.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
import torch.distributed as dist

from ultra_tpu_torch.models.nbfnet import ultra_score_all
from ultra_tpu_torch.parallel.mesh import Mesh
from ultra_tpu_torch.train.loop import make_train_step

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

# every all-reduce this process made: calls, bytes, and with timing on
# (timed_collectives) the seconds from before each call to its result on
# the device
stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
_timing = []


@contextlib.contextmanager
def timed_collectives():
    """Time each all-reduce (synchronising the device around it) while the
    block runs; ``stats["seconds"]`` sums them."""
    _timing.append(True)
    try:
        yield
    finally:
        _timing.pop()


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """In-place all-reduce of ``t`` (``op`` sum, max or min) over ``group``,
    counted in :data:`stats`."""
    stats["calls"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    if not _timing:
        dist.all_reduce(t, op=_OPS[op], group=group)
        return t
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=_OPS[op], group=group)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    stats["seconds"] += time.perf_counter() - t0
    return t


class _Combine(torch.autograd.Function):
    """All-reduce forward; the backward passes the gradient on, for MAX and
    MIN only where this shard's partial equals the combined value."""

    @staticmethod
    def forward(ctx, partial, group, kind: str):
        out = all_reduce(partial.clone(), kind, group)
        ctx.kind = kind
        if kind != "sum":
            ctx.save_for_backward(partial, out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.kind == "sum":
            return g, None, None
        partial, out = ctx.saved_tensors
        return torch.where(partial == out, g, torch.zeros((), dtype=g.dtype,
                                                          device=g.device)), None, None


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), "sum", ctx.group), None


def combine_shards(partial: torch.Tensor, group, kind: str = "sum") -> torch.Tensor:
    """The edge group's ``kind`` (sum, max, min) of each shard's partial
    aggregate, on every rank of ``group``."""
    return _Combine.apply(partial, group, kind)


def enter_shard(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated tensor as one shard's operand: ``x`` itself, whose
    gradient sums the shards' over ``group``."""
    return _Enter.apply(x, group)


def all_reduce_grads(model: torch.nn.Module, loss: torch.Tensor, group, size: int):
    """Average every parameter's gradient and ``loss`` over the ``size``
    ranks of ``group`` in one flattened all-reduce; returns the averaged
    loss. A parameter with no gradient counts as zeros, so every rank
    reduces the same layout."""
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    all_reduce(flat, "sum", group).div_(size)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat[-1]


def grad_sync(mesh: Mesh):
    """The train steps' ``sync_grads`` for ``mesh``: the average over its
    data group, or None without one."""
    if mesh.data_group is None:
        return None
    return functools.partial(all_reduce_grads, group=mesh.data_group, size=mesh.data)


def make_sharded_train_step(
    mesh: Mesh,
    adversarial_temperature: float = 1.0,
    num_negative: int = 256,
    per_rank_easy_edges: bool = False,
    grad_accum: int = 1,
):
    """Returns ``step(state, graph, batch, edge_weight) -> loss``.

    ``graph`` is this rank's block (``shard_graph(full, mesh)``); ``batch``
    (B, 1+K, 3) the global batch, B a multiple of ``mesh.data``;
    ``edge_weight`` the global easy-edge mask (E_pad,) over the full
    graph's padded edges (``tasks.easy_edge_weights``), or with
    ``per_rank_easy_edges`` one per data rank, (``mesh.data``, E_pad), row d
    from data rank d's rows: the reference-DDP compat mode, where every
    rank masks only its own rows' easy edges. Host arrays or tensors. The
    rank steps on its rows and its block; the loss returned is the global
    one, equal on every rank. ``grad_accum`` splits the rank's rows into
    micro-batches whose gradients are averaged before the all-reduce."""
    local = make_train_step(adversarial_temperature, num_negative, grad_accum,
                            sync_grads=grad_sync(mesh))

    def step(state, graph, batch, edge_weight):
        ew = edge_weight[mesh.data_index] if per_rank_easy_edges else edge_weight
        ew = ew[mesh.edge_block(ew.shape[-1])]
        device = graph.device
        return local(state, graph, torch.as_tensor(batch[mesh.rows(len(batch))], device=device),
                     torch.as_tensor(ew, dtype=torch.float32, device=device))

    return step


def make_sharded_score_step(mesh: Mesh):
    """Returns ``score(model, graph, batch) -> (t_pred, h_pred)``: the
    (B / data, V) all-node scores of this rank's rows of the global (B, 3)
    ``batch`` of (h, t, r) on its block ``graph``, tails and then heads
    through the inverse relation."""

    @torch.no_grad()
    def score(model, graph, batch):
        rows = torch.as_tensor(batch[mesh.rows(len(batch))], device=graph.device)
        h, t, r = rows[:, 0], rows[:, 1], rows[:, 2]
        num_direct = graph.num_relations // 2
        t_pred = ultra_score_all(model, graph, h, r_index=r)
        h_pred = ultra_score_all(model, graph, t, r_index=r + num_direct, query_r_index=r)
        return t_pred, h_pred

    return score

