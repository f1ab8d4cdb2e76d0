"""Relational graph container and its CSR layout.

Counterpart of ``ultra_tpu/graph.py``. The edge arrays keep the JAX
package's convention:

- ``edge_index`` (2, E_pad): row 0 is the message destination, row 1 the
  source. Output rows are ``edge_index[0]``; inputs are gathered from
  ``edge_index[1]``.
- ``edge_weight`` (E_pad,): **weight 0 means the edge is absent.** Padding
  and runtime edge removal zero weights instead of slicing arrays.

The CSR (:class:`CSR`) replaces the TPU planners
(``rspmm_pallas.py::GraphPlans.build`` / ``attach_plans`` and
``rspmm_pallas_v2.py::build_plan_v2``). It is built once per graph on the
host: rows are destinations, ``col`` holds sources, and ``eid`` indexes the
graph's padded weight vector, so a runtime weight mask reaches the kernel
with no rebuild.
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


@dataclasses.dataclass(frozen=True)
class Graph:
    """A relational graph with padded edge arrays and its CSR.

    ``relation_graph`` is the graph of relations (nodes = relation types,
    4 meta-relations), None for the relation graph itself.
    """

    edge_index: torch.Tensor  # (2, E_pad) int64
    edge_type: torch.Tensor  # (E_pad,) int64
    edge_weight: torch.Tensor  # (E_pad,) float32; 0.0 == absent
    num_nodes: int
    num_relations: int
    csr: CSR
    relation_graph: Optional["Graph"] = None

    @property
    def device(self) -> torch.device:
        return self.edge_weight.device

    def replace_weights(self, edge_weight: torch.Tensor) -> "Graph":
        """The same graph under a runtime weight mask; the CSR is kept."""
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
    """Build a padded :class:`Graph` (and its CSR) from host arrays.

    ``edge_index`` is (2, E) with row 0 = destination, row 1 = source.
    Padding edges self-loop on node 0 / relation 0 with weight 0. The CSR
    holds the edges live at build time (weight != 0); padding is left out.
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
    csr = build_csr(
        torch.from_numpy(edge_index[:, live]),
        torch.from_numpy(edge_type[live]),
        int(num_nodes),
        edge_ids=torch.from_numpy(live),
    )
    return Graph(
        edge_index=torch.from_numpy(edge_index),
        edge_type=torch.from_numpy(edge_type),
        edge_weight=torch.from_numpy(edge_weight),
        num_nodes=int(num_nodes),
        num_relations=int(num_relations),
        csr=csr,
        relation_graph=relation_graph,
    ).to(device)
