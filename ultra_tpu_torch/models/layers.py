"""Generalized relational convolution, the GNN layer of ULTRA.

Counterpart of ``ultra_tpu/models/layers.py``: one Bellman-Ford round over
node-major ``(V, B, D)`` states. Parameters live in a module whose names are
the reference checkpoint's (``linear``, ``layer_norm``, ``relation``,
``relation_projection.{0,2}``, ``relation_linear``), so a reference
``state_dict`` loads as it is.

Messages: ``distmult``, ``transe`` and ``rotate`` (complex rotation of
``(re, im)`` halves). Aggregators: ``sum``, ``mean``, ``max`` and ``pna``
(mean, max, min and std, each times 1, the log-degree scale and its
inverse: a 12-wide update, so ``linear`` takes ``13 * input_dim``). Every
combination runs on the rspmm kernels except ``rotate`` with ``max`` or
``pna``, which does not decompose into them and materialises one message
per edge in plain torch, as the JAX package does with plain XLA. Edge-
importance attribution asks the same of every message with ``max`` or
``pna`` (``per_edge=True``): its gradient must share a tie between the
tying edges, as XLA's segment reductions do, where the min/max rspmm gives
each of them the whole of it.

``compute_dtype: bfloat16`` rounds each conv's rspmm operands, the node
states and the relation features, to bf16 after ``layer_relation``, as the
JAX package's ``conv_apply`` does (``layers.py:302-305``), and holds the
port to its Pallas path: the kernels accumulate in f32 and write f32
(``ops/rspmm.py``). PNA's squares are taken of the bf16 tensors, in bf16;
the boundary, the degree, the PNA features, ``linear``, ``layer_norm`` and
the activation stay f32, and ``linear`` sees the rounded input widened
back to f32, as the JAX package's concatenation promotes it, while the short
cut adds the f32 layer input (``bellmanford``'s ``residual``). At inference
E2's bf16-x instance takes the f32 input and rounds it on chip
(``_tail``), so the rounded copy feeds only the rspmm. The casts count their
bytes read and written in the profiling counter ``cast_bytes``. The per-edge
path rounds its operands the same way and computes in f32. ``rotate`` with
``max`` or ``pna`` is left in f32, as the JAX package returns from it
before the cast.

On one block of a graph's edges (``Graph.edge_group``, set by
``parallel/mesh.py::shard_graph``) each aggregate is a partial over the
block, combined over the edge group (``parallel/dp.py``): sums and the
degree with a sum, max and min with a max and a min. The relation graph is
never cut, so the relation model's convs never combine.
"""

from __future__ import annotations

import dataclasses
import logging

import torch
import torch.nn.functional as F
from torch import nn

from ultra_tpu_torch.graph import Graph
from ultra_tpu_torch.ops import conv_tail_cuda, epilogue_cuda
from ultra_tpu_torch.ops.rspmm import degree, rspmm_from_graph
from ultra_tpu_torch.utils import profiling

EPS = 1e-6  # PNA std clamp

logger = logging.getLogger(__name__)

_MESSAGE2MUL = {"transe": "add", "distmult": "mul"}
_MESSAGES = ("distmult", "transe", "rotate")
_AGGREGATES = ("sum", "mean", "max", "pna")
# the kernels' operand types: None and "float32" leave the operands as they
# are; a float16 would need kernels of its own
COMPUTE_DTYPES = (None, "float32", "bfloat16")


def check_compute_dtype(compute_dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got "
                         f"{compute_dtype!r}")


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    input_dim: int = 64
    output_dim: int = 64
    num_relation: int = 4
    message_func: str = "distmult"  # distmult | transe | rotate
    aggregate_func: str = "sum"  # sum | mean | max | pna
    layer_norm: bool = True
    activation: str = "relu"
    dependent: bool = False
    project_relations: bool = False
    compute_dtype: str | None = None  # "bfloat16": the rspmm operands in bf16

    def __post_init__(self):
        check_compute_dtype(self.compute_dtype)


def pna_features(sum_, sq_sum, max_, min_, boundary, deg):
    """PNA's (V, B, 12*D) update: {mean, max, min, std} x {1, log-degree
    scale, its inverse}, the boundary folded in as one more self-message.
    ``deg`` (V, 1, 1) counts live in-edges plus that self-message.

    The clips are ``torch.maximum`` against a constant, as ``jnp.clip`` is:
    at a tie both split the gradient in half, where ``torch.clamp`` would
    give all of it to the input. Ties are common: at the first layer most
    rows of the input are 0, so ``max_``, ``min_`` and the boundary tie."""
    mean = (sum_ + boundary) / deg
    sq_mean = (sq_sum + boundary.square()) / deg
    max_ = torch.maximum(max_, boundary)
    min_ = torch.minimum(min_, boundary)
    eps = torch.tensor(EPS, dtype=mean.dtype, device=mean.device)
    std = torch.sqrt(torch.maximum(sq_mean - mean.square(), eps))
    features = torch.stack([mean, max_, min_, std], dim=-1)  # (V, B, D, 4)
    features = features.reshape(*features.shape[:-2], -1)  # (V, B, 4D)
    scale = torch.log(deg)
    scale = scale / scale.mean()
    floor = torch.tensor(1e-2, dtype=scale.dtype, device=scale.device)
    scales = torch.cat([torch.ones_like(scale), scale, 1.0 / torch.maximum(scale, floor)],
                       dim=-1)  # (V, 1, 3)
    return (features[..., None] * scales[..., None, :]).reshape(*features.shape[:-1], -1)


def _rotate_sum_rspmm(graph: Graph, relation, input):
    """The rotate message summed, as ONE distmult sum rspmm at twice the
    width: the complex product is bilinear, so with
    ``S(r, x)[v] = sum_e w_e * r[type_e] * x[src_e]``

        out_re = S(r_re, x_re) - S(r_im, x_im)
        out_im = S(r_im, x_re) + S(r_re, x_im)

    and stacking ``[x_re | x_im | x_re | x_im]`` against
    ``[r_re | r_im | r_im | r_re]`` gives all four terms in one call."""
    d = input.shape[-1] // 2
    x_re, x_im = input[..., :d], input[..., d:]
    r_re, r_im = relation[..., :d], relation[..., d:]
    x4 = torch.cat([x_re, x_im, x_re, x_im], dim=-1)
    r4 = torch.cat([r_re, r_im, r_im, r_re], dim=-1)
    out4 = rspmm_from_graph(graph, r4, x4, sum="add", mul="mul")
    return torch.cat([out4[..., :d] - out4[..., d:2 * d],
                      out4[..., 2 * d:3 * d] + out4[..., 3 * d:]], dim=-1)


def _cast(t, dtype):
    """``t.to(dtype)``; a cast that copies counts the bytes it reads and
    writes in the profiling counter ``cast_bytes``."""
    if t.dtype == dtype:
        return t
    profiling.count("cast_bytes", t.numel() * (t.element_size() + dtype.itemsize))
    return t.to(dtype)


def _shard_ops(graph: Graph):
    """``(enter, combine)`` for a conv on ``graph``. On one block of a
    graph's edges (``graph.edge_group``: ``parallel/mesh.py::shard_graph``)
    the replicated node states and relation features enter the shard and
    each partial aggregate combines over the group, with ``combine(t,
    kind)`` for kind sum, max or min (``parallel/dp.py``, which has the
    gradient's account); on a whole graph both are the identity."""
    group = graph.edge_group
    if group is None:
        return (lambda t: t), (lambda t, kind="sum": t)
    from ultra_tpu_torch.parallel import dp  # dp imports the models

    return (lambda t: dp.enter_shard(t, group),
            lambda t, kind="sum": dp.combine_shards(t, group, kind))


def _per_edge_messages(message_func: str, graph: Graph, input, relation):
    """Unweighted (E, B, D) messages of every padded edge, and the messages
    PNA's second moment sums: ``msg ** 2`` for rotate, ``op(rel ** 2, x ** 2)``
    for distmult and transe (the rspmm of squares, as ``_update`` takes it)."""
    x_e = input.index_select(0, graph.edge_index[1])
    r_e = relation.index_select(0, graph.edge_type)
    if message_func == "rotate":
        d = x_e.shape[-1] // 2
        x_re, x_im = x_e[..., :d], x_e[..., d:]
        r_re, r_im = r_e[..., :d], r_e[..., d:]
        msg = torch.cat([x_re * r_re - x_im * r_im, x_re * r_im + x_im * r_re], dim=-1)
        return msg, lambda: msg.square()
    if message_func == "distmult":
        return r_e * x_e, lambda: r_e.square() * x_e.square()
    return r_e + x_e, lambda: r_e.square() + x_e.square()


def _per_edge_update(aggregate: str, message_func: str, graph: Graph, input, boundary,
                     relation):
    """``max`` or ``pna`` over one (E, B, D) message per padded edge, reduced
    with index_add and scatter_reduce (whose gradient shares a tie between
    the tying edges, as the JAX package's XLA segment reductions do). Meant
    for small graphs: it warns past 2^28 elements."""
    n_elem = graph.edge_index.shape[1] * input.shape[1] * input.shape[2]
    if n_elem > 1 << 28:
        logger.warning(
            "%s + %s uses the per-edge path: materializes %.2g message "
            "elements (O(E*B*D)); use sum/mean aggregation for the fused kernel "
            "path.", message_func, aggregate, float(n_elem),
        )
    enter, combine = _shard_ops(graph)
    dst, w = graph.edge_index[0], graph.edge_weight[:, None, None]
    msg, squares = _per_edge_messages(message_func, graph, enter(input), enter(relation))
    shape = (graph.num_nodes,) + tuple(msg.shape[1:])

    def seg_sum(m):
        return combine(torch.zeros(shape, dtype=m.dtype, device=m.device).index_add(0, dst, m * w))

    def seg_ext(m, is_min):
        fill = float("inf") if is_min else float("-inf")
        m = torch.where(w != 0.0, m * w, torch.full((), fill, dtype=m.dtype, device=m.device))
        out = torch.full(shape, fill, dtype=m.dtype, device=m.device)
        return combine(out.scatter_reduce(0, dst.view(-1, 1, 1).expand_as(m), m,
                                          "amin" if is_min else "amax", include_self=True),
                       "min" if is_min else "max")

    if aggregate == "max":
        return torch.maximum(seg_ext(msg, is_min=False), boundary)
    deg = combine(degree(graph, include_self_loop=False))[:, None, None] + 1.0
    return pna_features(seg_sum(msg), seg_sum(squares()), seg_ext(msg, is_min=False),
                        seg_ext(msg, is_min=True), boundary, deg)


class GeneralizedRelationalConv(nn.Module):
    """One conv layer; ``forward`` is the JAX package's ``conv_apply``."""

    def __init__(self, cfg: ConvConfig):
        super().__init__()
        if cfg.message_func not in _MESSAGES:
            raise ValueError(f"message_func must be one of {_MESSAGES}, got "
                             f"{cfg.message_func!r}")
        if cfg.aggregate_func not in _AGGREGATES:
            raise ValueError(f"aggregate_func must be one of {_AGGREGATES}, got "
                             f"{cfg.aggregate_func!r}")
        if cfg.message_func == "rotate" and cfg.input_dim % 2:
            raise ValueError(f"rotate needs an even input_dim (complex pairs), got "
                             f"{cfg.input_dim}")
        self.cfg = cfg
        d_in, d_out = cfg.input_dim, cfg.output_dim
        # [input | update]: the update is d_in wide, or 12 * d_in for pna
        self.linear = nn.Linear((13 if cfg.aggregate_func == "pna" else 2) * d_in, d_out)
        if cfg.layer_norm:
            self.layer_norm = nn.LayerNorm(d_out, eps=1e-5)
        if cfg.dependent:
            self.relation_linear = nn.Linear(d_in, cfg.num_relation * d_in)
        elif cfg.project_relations:
            self.relation_projection = nn.Sequential(
                nn.Linear(d_in, d_in), nn.ReLU(), nn.Linear(d_in, d_in)
            )
        else:
            self.relation = nn.Embedding(cfg.num_relation, d_in)

    def layer_relation(self, query=None, relation_input=None):
        """Per-layer relation features, (R, B, D).

        - dependent: project the (B, D) query to (R, B, D);
        - project_relations: an MLP on the injected (B, R, D) relation
          representations (the relation graph's output);
        - default: the layer's (R, D) embedding broadcast over the batch.
        """
        cfg = self.cfg
        if cfg.dependent:
            b = query.shape[0]
            rel = self.relation_linear(query).view(b, cfg.num_relation, cfg.input_dim)
            return rel.transpose(0, 1)
        if cfg.project_relations:
            return self.relation_projection(relation_input).transpose(0, 1)
        rel = self.relation.weight
        return rel[:, None, :].expand(rel.shape[0], query.shape[0], rel.shape[1])

    def forward(
        self,
        graph: Graph,
        input: torch.Tensor,  # (V, B, D) node states
        boundary: torch.Tensor,  # (V, B, D) layer-0 boundary condition
        query: torch.Tensor = None,  # (B, D) query embeddings
        relation_input: torch.Tensor = None,  # (B, R, D) injected relation reprs
        per_edge: bool = False,
        residual: torch.Tensor = None,  # (V, B, output_dim) the short cut's input
        rows: tuple = None,  # ((B,) flat rows of (V*B, D), (B, D)): boundary's nonzero rows
    ) -> torch.Tensor:
        """One message-passing round; returns (V, B, output_dim), plus
        ``residual`` where given (the short cut, added after the
        activation). With ``per_edge``, ``max`` and ``pna`` reduce one
        message per edge in plain torch (see the module note) for every
        message function. ``rows``, where the boundary was scattered from
        them (``nbfnet.py::boundary_rows``), lets a sum or mean conv add
        the boundary as those rows (:meth:`_update`)."""
        cfg = self.cfg
        relation = self.layer_relation(query, relation_input)
        aggregate = cfg.aggregate_func
        edgewise = aggregate in ("max", "pna") and (per_edge or cfg.message_func == "rotate")
        x = input  # the layer's input as it came: E2 takes it, and rounds it itself
        if cfg.compute_dtype and not (edgewise and cfg.message_func == "rotate"):
            dtype = getattr(torch, cfg.compute_dtype)
            input, relation = _cast(input, dtype), _cast(relation, dtype)
        if edgewise:
            update = _per_edge_update(aggregate, cfg.message_func, graph,
                                      input.to(boundary.dtype), boundary,
                                      relation.to(boundary.dtype))
        else:
            update = self._update(graph, input, boundary, relation, rows)
        if self._tail(x, input, update, residual):
            ln = self.layer_norm
            return conv_tail_cuda.conv_tail(x, update, self.linear.weight, self.linear.bias,
                                            ln.weight, ln.bias, ln.eps,
                                            cfg.activation == "relu", residual,
                                            round_x=input.dtype == torch.bfloat16)
        output = self.linear(torch.cat([input.to(update.dtype), update], dim=-1))
        return self._epilogue(output, residual)

    def _tail(self, x, input, update, residual) -> bool:
        """Whether one call of ``conv_tail_cuda.conv_tail`` (E2, one kernel
        on the card) computes the linear of ``[input | update]``, the layer
        norm, the activation and the short cut: where no gradient is wanted,
        the layer norm is on, the activation ReLU or none, the linear 64 ->
        64 over the two, every operand f32 (``input`` may be ``x`` rounded
        to bf16, which E2's bf16-x instance rounds from ``x`` itself), ``x``
        and ``update`` of one shape, contiguous and 16-byte aligned, and the
        short cut's input none or ``x`` itself. Else the linear, then
        :meth:`_epilogue`."""
        cfg = self.cfg
        if not cfg.layer_norm or cfg.activation not in ("relu", None, ""):
            return False
        width = conv_tail_cuda.WIDTH
        if self.linear.weight.shape != (width, 2 * width) or update.shape != x.shape:
            return False
        if residual is not None and residual is not x:
            return False
        if input is not x and input.dtype != torch.bfloat16:
            return False
        operands = (x, update, self.linear.weight, self.linear.bias, self.layer_norm.weight,
                    self.layer_norm.bias)
        if any(t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16
               for t in operands):
            return False
        return not (torch.is_grad_enabled() and any(t.requires_grad for t in operands))

    def _epilogue(self, output, residual):
        """Layer norm, activation and short cut, where :meth:`_tail` does
        not take the layer. Where no gradient is wanted, the layer norm is
        on, the activation ReLU or none and the output f32 of a width E1 is
        built for, one call of ``epilogue_cuda.conv_epilogue`` (one kernel
        on the card); else the composed ops, whose autograd graph training,
        remat and attribution need."""
        cfg = self.cfg
        if self._fused(output, residual):
            ln = self.layer_norm
            if residual is not None:
                residual = residual.contiguous()
            return epilogue_cuda.conv_epilogue(output, ln.weight, ln.bias, ln.eps,
                                               cfg.activation == "relu", residual)
        if cfg.layer_norm:
            output = self.layer_norm(output)
        if cfg.activation:
            output = getattr(F, cfg.activation)(output)
        return output if residual is None else output + residual

    def _fused(self, output, residual) -> bool:
        cfg = self.cfg
        if not cfg.layer_norm or cfg.activation not in ("relu", None, ""):
            return False
        if output.dtype != torch.float32 or output.shape[-1] not in epilogue_cuda.WIDTHS:
            return False
        if residual is not None and (residual.dtype != torch.float32
                                     or residual.shape != output.shape):
            return False
        operands = (output, self.layer_norm.weight, self.layer_norm.bias, residual)
        return not (torch.is_grad_enabled()
                    and any(t is not None and t.requires_grad for t in operands))

    def _update(self, graph: Graph, input, boundary, relation, rows=None):
        """The aggregated update on the rspmm kernels, boundary folded in.

        ``sum`` and ``mean`` add the boundary to the combined aggregate. With
        ``rows`` (the entity and relation models' scattered boundaries,
        ``nbfnet.py::boundary_rows``) that is one ``index_add_`` of the B
        nonzero rows onto the aggregate's (V*B, D) view, in place: every
        producer of the aggregate (the sum rspmm, rotate's ``cat``, the
        edge group's combine) returns a fresh tensor that no backward
        saves, so autograd takes the write too. It is the dense add's
        result bit for bit: the flat rows are distinct, so each nonzero
        element gets the one f32 addition the dense add makes there, and
        every other element is ``update + 0.0``, which is ``update``, since
        a sum that starts at +0.0 never holds -0.0. Without ``rows``
        (UltraQuery's fuzzy sets, attribution's convs) the dense add.
        ``max`` and ``pna`` read every row of the dense boundary."""
        cfg = self.cfg
        aggregate = cfg.aggregate_func
        enter, combine = _shard_ops(graph)
        input, relation = enter(input), enter(relation)
        if aggregate in ("sum", "mean"):
            if cfg.message_func == "rotate":
                update = _rotate_sum_rspmm(graph, relation, input)
            else:
                update = rspmm_from_graph(graph, relation, input, sum="add",
                                          mul=_MESSAGE2MUL[cfg.message_func])
            update = combine(update)
            if rows is None:
                update = update + boundary
            else:
                index, values = rows
                update.view(-1, update.shape[-1]).index_add_(0, index, values)
                profiling.count("boundary_rows", 1)
            if aggregate == "mean":
                deg = combine(degree(graph, include_self_loop=False))
                update = update / (deg[:, None, None] + 1.0)
            return update
        mul = _MESSAGE2MUL[cfg.message_func]
        max_ = combine(rspmm_from_graph(graph, relation, input, sum="max", mul=mul), "max")
        if aggregate == "max":
            return torch.maximum(max_, boundary)
        # pna. Its sum of squares is rspmm(rel^2, x^2), as the reference
        # computes it: for transe that is sum w (r^2 + x^2), not sum (w m)^2.
        return pna_features(
            combine(rspmm_from_graph(graph, relation, input, sum="add", mul=mul)),
            combine(rspmm_from_graph(graph, relation.square(), input.square(), sum="add",
                                     mul=mul)),
            max_,
            combine(rspmm_from_graph(graph, relation, input, sum="min", mul=mul), "min"),
            boundary,
            combine(degree(graph, include_self_loop=False))[:, None, None] + 1.0,
        )
