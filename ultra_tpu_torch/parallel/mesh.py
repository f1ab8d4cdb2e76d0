"""The ranks of a run laid out as a (data, edge) grid, and a rank's block of
a graph's edges.

Counterpart of ``ultra_tpu/parallel/mesh.py``:

- ``data``: batch parallelism. Each row of the grid scores its own rows of
  the batch; gradients are averaged over a column (the data group).
- ``edge``: graph partitioning. The ranks of a row each hold a contiguous
  block of the padded edge arrays, compute partial aggregates over it, and
  combine them with one all-reduce per aggregate (the edge group;
  ``parallel/dp.py``).

Node states, parameters and the relation graph are replicated. The JAX
package's per-shard Pallas plan tables (``sharded_plans``,
``build_sharded_plans``) have no counterpart: a rank's block is an ordinary
graph with its own edge layouts, which the kernels walk as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from ultra_tpu_torch.graph import Graph, make_graph
from ultra_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, edge) grid: rank = d * edge + e.

    ``data_group`` holds the ranks of this rank's column (None without a
    process group); ``edge_group`` those of its row (None when ``edge`` is
    1: there is nothing to combine)."""

    data: int
    edge: int
    data_index: int = 0
    edge_index: int = 0
    data_group: Optional[object] = None
    edge_group: Optional[object] = None

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``, which must
        divide evenly over the data axis (every rank's loss weighs the same
        in the average)."""
        if n % self.data:
            raise ValueError(f"a batch of {n} rows does not divide over {self.data} data ranks")
        per = n // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def edge_block(self, num_edges_padded: int) -> slice:
        """This rank's contiguous block of a graph's padded edges."""
        if num_edges_padded % self.edge:
            raise ValueError(f"{num_edges_padded} padded edges do not divide over "
                             f"{self.edge} edge ranks")
        per = num_edges_padded // self.edge
        return slice(self.edge_index * per, (self.edge_index + 1) * per)


def make_mesh(data: Optional[int] = None, edge: int = 1) -> Mesh:
    """The grid over every rank of the process group (one rank without one),
    by default all on the data axis. Every rank makes every row's and every
    column's group, in the same order, as ``torch.distributed.new_group``
    asks."""
    world, rank = multihost.process_count(), multihost.process_index()
    if data is None:
        data = world // edge
    if data * edge != world:
        raise ValueError(f"mesh {data}x{edge} != {world} ranks")
    d, e = divmod(rank, edge)
    if not dist.is_initialized():
        return Mesh(data, edge, d, e)
    edge_group = data_group = None
    if edge > 1:
        for row in range(data):
            group = dist.new_group([row * edge + c for c in range(edge)])
            if row == d:
                edge_group = group
    for col in range(edge):
        group = dist.new_group([r * edge + col for r in range(data)])
        if col == e:
            data_group = group
    return Mesh(data, edge, d, e, data_group, edge_group)


def shard_graph(graph: Graph, mesh: Mesh) -> Graph:
    """This rank's block of ``graph``'s edges as a :class:`Graph` on the same
    device: the contiguous 1/``edge`` slice of the padded edge arrays (as
    ``P(None, edge)`` cuts them), with its own edge layouts, ``graph``'s
    node and relation counts, the whole relation graph, and the edge group
    to combine over. ``graph`` itself when ``edge`` is 1. A per-step weight
    mask over the global padded edges reaches the block as
    ``mask[mesh.edge_block(len(mask))]``."""
    if mesh.edge == 1:
        return graph
    block = mesh.edge_block(graph.num_edges_padded)
    shard = make_graph(graph.edge_index[:, block].cpu().numpy(),
                       graph.edge_type[block].cpu().numpy(), graph.num_nodes,
                       graph.num_relations, edge_weight=graph.edge_weight[block].cpu().numpy(),
                       device=graph.device)
    return dataclasses.replace(shard, relation_graph=graph.relation_graph,
                               edge_group=mesh.edge_group)
