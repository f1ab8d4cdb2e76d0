"""Relational graph container and its CSR layout.

Counterpart of ``ultra_tpu/graph.py``. The edge arrays keep the JAX
package's convention:

- ``edge_index`` (2, E_pad): row 0 is the message destination, row 1 the
  source. Output rows are ``edge_index[0]``; inputs are gathered from
  ``edge_index[1]``.
- ``edge_weight`` (E_pad,): **weight 0 means the edge is absent.** Padding
  and runtime edge removal zero weights instead of slicing arrays.

Three host layouts of the live edges replace the TPU planners
(``rspmm_pallas.py::GraphPlans.build`` / ``attach_plans`` and
``rspmm_pallas_v2.py::build_plan_v2``). They are built once per graph, and
each edge carries ``eid``, its slot in the graph's padded weight vector, so
a runtime weight mask reaches every kernel with no rebuild:

- ``csr`` (:class:`CSR`): rows are destinations, ``col`` holds sources. The
  forward walks it.
- ``csr_src``: the transpose, rows are sources and ``col`` holds
  destinations. The input gradient walks it.
- ``segments`` (:class:`TypeSegments`): edges sorted by type, cut into
  chunks of at most :data:`SEGMENT_CHUNK` edges. The relation gradient
  walks it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA on a machine without a card
    instead of running somewhere the caller did not ask for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass(frozen=True)
class CSR:
    """Edges grouped by destination row.

    ``rowptr`` (V+1,) int64; ``col`` (source), ``etype`` and ``eid`` (index
    into the graph's edge-weight vector) are (E_live,) int32.
    """

    rowptr: torch.Tensor
    col: torch.Tensor
    etype: torch.Tensor
    eid: torch.Tensor

    def to(self, device) -> "CSR":
        return CSR(*(t.to(device) for t in dataclasses.astuple(self)))


SEGMENT_CHUNK = 256  # edges per chunk of a type segment


@dataclasses.dataclass(frozen=True)
class TypeSegments:
    """Edges sorted by type (stable, so destination-major within a type),
    each type's run cut into chunks of at most :data:`SEGMENT_CHUNK` edges.

    ``etype``, ``src``, ``dst`` and ``eid`` are (E_live,) int32. Chunk ``k``
    holds edges ``chunkptr[k]:chunkptr[k+1]`` (``chunkptr`` (K+1,) int64);
    the chunks of type ``t`` are ``type_chunkptr[t]:type_chunkptr[t+1]``
    (``type_chunkptr`` (R+1,) int64). A type with no edges has no chunk.
    """

    etype: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    eid: torch.Tensor
    chunkptr: torch.Tensor
    type_chunkptr: torch.Tensor

    @property
    def num_types(self) -> int:
        return self.type_chunkptr.numel() - 1

    def to(self, device) -> "TypeSegments":
        return TypeSegments(*(t.to(device) for t in dataclasses.astuple(self)))


def build_segments(csr: CSR, num_types: int) -> TypeSegments:
    """The type segments of ``csr``'s edges, with their chunk table.

    Many chunks per type let one type's edges spread over many blocks: the
    relation graph has 4 types, and a block per type would leave most of the
    card idle."""
    device = csr.col.device
    num_rows = csr.rowptr.numel() - 1
    dst = torch.repeat_interleave(
        torch.arange(num_rows, device=device), csr.rowptr.diff(),
        output_size=csr.col.numel(),
    )
    etype = csr.etype.long()
    order = torch.argsort(etype, stable=True)
    counts = torch.bincount(etype, minlength=num_types)
    chunks = -(-counts // SEGMENT_CHUNK)  # per type
    type_chunkptr = torch.zeros(num_types + 1, dtype=torch.int64, device=device)
    type_chunkptr[1:] = torch.cumsum(chunks, 0)
    # chunk k of type t starts at t's first edge + SEGMENT_CHUNK * (k - t's first chunk)
    type_start = torch.cumsum(counts, 0) - counts
    chunk_type = torch.repeat_interleave(
        torch.arange(num_types, device=device), chunks, output_size=int(type_chunkptr[-1]),
    )
    k = torch.arange(chunk_type.numel(), device=device)
    chunkptr = torch.empty(chunk_type.numel() + 1, dtype=torch.int64, device=device)
    chunkptr[:-1] = type_start[chunk_type] + SEGMENT_CHUNK * (k - type_chunkptr[chunk_type])
    chunkptr[-1] = csr.col.numel()
    return TypeSegments(
        etype=etype[order].to(torch.int32),
        src=csr.col[order],
        dst=dst[order].to(torch.int32),
        eid=csr.eid[order],
        chunkptr=chunkptr,
        type_chunkptr=type_chunkptr,
    )


def build_csr(edge_index, edge_type, num_nodes: int, edge_ids=None) -> CSR:
    """Destination-major CSR of the given edges.

    ``edge_ids`` are the edges' slots in the weight vector (default
    ``arange(E)``). Works on tensors of any device; the sort is stable, so
    each row keeps its edges in input order.
    """
    edge_index = torch.as_tensor(edge_index)
    edge_type = torch.as_tensor(edge_type)
    dst = edge_index[0].long()
    if edge_ids is None:
        edge_ids = torch.arange(dst.numel(), device=dst.device)
    edge_ids = torch.as_tensor(edge_ids, device=dst.device)
    order = torch.argsort(dst, stable=True)
    counts = torch.bincount(dst, minlength=num_nodes)
    rowptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dst.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    return CSR(
        rowptr=rowptr,
        col=edge_index[1][order].to(torch.int32),
        etype=edge_type[order].to(torch.int32),
        eid=edge_ids[order].to(torch.int32),
    )


def build_layouts(edge_index, edge_type, num_nodes: int, num_types: int, edge_ids=None):
    """(csr, csr_src, segments) of the given edges: the three layouts the
    forward, the input gradient and the relation gradient walk."""
    edge_index = torch.as_tensor(edge_index)
    csr = build_csr(edge_index, edge_type, num_nodes, edge_ids)
    csr_src = build_csr(edge_index.flip(0), edge_type, num_nodes, edge_ids)
    return csr, csr_src, build_segments(csr, num_types)


@dataclasses.dataclass(frozen=True)
class Graph:
    """A relational graph with padded edge arrays and its three edge
    layouts (``csr``, ``csr_src``, ``segments``: see the module note).

    ``relation_graph`` is the graph of relations (nodes = relation types,
    4 meta-relations), None for the relation graph itself.
    """

    edge_index: torch.Tensor  # (2, E_pad) int64
    edge_type: torch.Tensor  # (E_pad,) int64
    edge_weight: torch.Tensor  # (E_pad,) float32; 0.0 == absent
    num_nodes: int
    num_relations: int
    csr: CSR
    csr_src: CSR
    segments: TypeSegments
    relation_graph: Optional["Graph"] = None

    @property
    def device(self) -> torch.device:
        return self.edge_weight.device

    @property
    def num_edges_padded(self) -> int:
        return self.edge_weight.numel()

    def replace_weights(self, edge_weight: torch.Tensor) -> "Graph":
        """The same graph under a runtime weight mask; the layouts are kept."""
        if edge_weight.shape != self.edge_weight.shape:
            raise ValueError(
                f"edge_weight {tuple(edge_weight.shape)} does not match the "
                f"graph's {tuple(self.edge_weight.shape)}"
            )
        return dataclasses.replace(self, edge_weight=edge_weight)

    def to(self, device) -> "Graph":
        device = resolve_device(device)
        return dataclasses.replace(
            self,
            edge_index=self.edge_index.to(device),
            edge_type=self.edge_type.to(device),
            edge_weight=self.edge_weight.to(device),
            csr=self.csr.to(device),
            csr_src=self.csr_src.to(device),
            segments=self.segments.to(device),
            relation_graph=(
                None if self.relation_graph is None
                else self.relation_graph.to(device)
            ),
        )


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def pad_bucket(n: int, multiple: int = 2048, growth: float = 1.0) -> int:
    """Bucketed padding size: next multiple of ``multiple`` >= n * growth."""
    return max(multiple, round_up(int(np.ceil(n * growth)), multiple))


def make_graph(
    edge_index,
    edge_type,
    num_nodes: int,
    num_relations: int,
    edge_weight=None,
    pad_to: Optional[int] = None,
    relation_graph: Optional[Graph] = None,
    device="cuda",
) -> Graph:
    """Build a padded :class:`Graph` (and its edge layouts) from host arrays.

    ``edge_index`` is (2, E) with row 0 = destination, row 1 = source.
    Padding edges self-loop on node 0 / relation 0 with weight 0. The
    layouts hold the edges live at build time (weight != 0); padding is
    left out.
    """
    device = resolve_device(device)
    edge_index = np.asarray(edge_index, dtype=np.int64)
    edge_type = np.asarray(edge_type, dtype=np.int64)
    num_edges = edge_index.shape[1]
    if edge_weight is None:
        edge_weight = np.ones(num_edges, dtype=np.float32)
    else:
        edge_weight = np.asarray(edge_weight, dtype=np.float32)
    if num_edges and (edge_index.min() < 0 or edge_index.max() >= num_nodes):
        raise ValueError(f"edge_index out of range for {num_nodes} nodes")
    if num_edges and (edge_type.min() < 0 or edge_type.max() >= num_relations):
        raise ValueError(f"edge_type out of range for {num_relations} relations")
    if num_edges >= 2**31:
        raise ValueError("the CSR holds 32-bit edge ids")

    if pad_to is None:
        pad_to = num_edges
    if pad_to < num_edges:
        raise ValueError(f"pad_to={pad_to} < {num_edges} edges")
    pad = pad_to - num_edges
    edge_index = np.pad(edge_index, ((0, 0), (0, pad)))
    edge_type = np.pad(edge_type, (0, pad))
    edge_weight = np.pad(edge_weight, (0, pad))

    live = np.nonzero(edge_weight != 0.0)[0]
    csr, csr_src, segments = build_layouts(
        torch.from_numpy(edge_index[:, live]),
        torch.from_numpy(edge_type[live]),
        int(num_nodes),
        int(num_relations),
        edge_ids=torch.from_numpy(live),
    )
    return Graph(
        edge_index=torch.from_numpy(edge_index),
        edge_type=torch.from_numpy(edge_type),
        edge_weight=torch.from_numpy(edge_weight),
        num_nodes=int(num_nodes),
        num_relations=int(num_relations),
        csr=csr,
        csr_src=csr_src,
        segments=segments,
        relation_graph=relation_graph,
    ).to(device)
