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

  Each CSR also cuts its rows into pieces of at most :data:`ROW_PIECE`
  edges (the piece table, see :class:`CSR`). The sum and min/max forwards
  (B1, B3) and, on ``csr_src``, the sum and min/max input gradients (B1,
  B4) give each piece to its own group of threads, so a hub row (in
  FB15k-237's shape, 3,031 edges against a mean of 37) spreads over many
  groups instead of setting the launch's length, and a second pass combines
  the pieces of each long row in a fixed order. The edge-weight gradient
  (B6), one value an edge, walks the same pieces with no second pass.
- ``segments`` (:class:`TypeSegments`): edges sorted by type. Each type's
  run is cut into pieces (a piece table as a CSR's, with the type as the
  row, of :func:`segment_piece` edges), which the sum and min/max relation
  gradients B2 and B5 walk.
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
    """Edges grouped by destination row, with the rows' piece table.

    ``rowptr`` (V+1,) int64; ``col`` (source), ``etype`` and ``eid`` (index
    into the graph's edge-weight vector) are (E_live,) int32.

    Piece ``p`` holds edges ``piece_ptr[p]:piece_ptr[p+1]`` (``piece_ptr``
    (P+1,) int64) of row ``piece_row[p]`` ((P,) int32). Pieces follow CSR
    order and hold at most :data:`ROW_PIECE` edges; a row has
    ``max(1, ceil(degree / ROW_PIECE))`` of them, so an empty row is one
    piece of no edges. ``piece_slot`` ((P,) int32) is -1 for the piece of a
    one-piece row, which writes its row of the output; the pieces of a
    longer row take consecutive slots in edge order, each a partial row of
    a scratch buffer. ``piece_order`` ((P,) int32) is the order the kernels
    take the pieces in: longest first, CSR order among equals, so the
    longest pieces start first and the groups that run side by side get
    pieces of about one length. ``long_rows`` ((L,) int32) are the rows of
    more than one piece, in row order, and ``long_slot_ptr`` ((L+1,) int64)
    their slot ranges: the second pass combines slots
    ``long_slot_ptr[i]:long_slot_ptr[i+1]`` into row ``long_rows[i]``. The
    slots number P - V + L (:attr:`num_slots`).

    A CSR checks these types, lengths and its one device when it is made,
    so the forwards' wrappers, which run on every layer, check only ``col``
    of it and trust the rest.
    """

    rowptr: torch.Tensor
    col: torch.Tensor
    etype: torch.Tensor
    eid: torch.Tensor
    piece_ptr: torch.Tensor
    piece_row: torch.Tensor
    piece_slot: torch.Tensor
    piece_order: torch.Tensor
    long_rows: torch.Tensor
    long_slot_ptr: torch.Tensor

    def __post_init__(self):
        edges = self.col.numel()
        _check_fields(self, self.col, {"rowptr": (torch.int64, self.rowptr.numel()),
                                       "col": (torch.int32, edges),
                                       "etype": (torch.int32, edges),
                                       "eid": (torch.int32, edges)})

    @property
    def num_slots(self) -> int:
        """Partial rows of the long rows' pieces, from the shapes alone (every
        row has at least one piece), so reading it never waits on the card."""
        return _num_slots(self, self.rowptr.numel() - 1)

    def to(self, device) -> "CSR":
        return CSR(*(t.to(device) for t in dataclasses.astuple(self)))


def _check_fields(layout, like: torch.Tensor, want: dict) -> None:
    """Checks a layout's tensors of ``want`` (name -> (dtype, length)) and
    its piece table: 1-D, of those types and lengths, contiguous on
    ``like``'s device."""
    pieces, long = layout.piece_row.numel(), layout.long_rows.numel()
    want = {**want, "piece_ptr": (torch.int64, pieces + 1), "piece_row": (torch.int32, pieces),
            "piece_slot": (torch.int32, pieces), "piece_order": (torch.int32, pieces),
            "long_rows": (torch.int32, long), "long_slot_ptr": (torch.int64, long + 1)}
    kind = type(layout).__name__
    for name, (dtype, length) in want.items():
        t = getattr(layout, name)
        if t.dtype != dtype or t.dim() != 1 or t.numel() != length:
            raise ValueError(f"{kind}: {name} must be 1-D {dtype} of length {length}")
        if t.device != like.device or not t.is_contiguous():
            raise ValueError(f"{kind}: {name} must be contiguous on {like.device}")


def _num_slots(layout, num_rows: int) -> int:
    return layout.piece_row.numel() - num_rows + layout.long_rows.numel()


ROW_PIECE = 128  # edges per piece of a CSR row
# the lengths a type segment's pieces may take, and the pieces the relation
# gradient should have at least: 4 groups of threads on each of an H100's
# 132 SMs (segment_piece)
SEGMENT_PIECES = (256, 128, 64, 32)
SEGMENT_MIN_PIECES = 4 * 132


def segment_piece(counts: torch.Tensor) -> int:
    """The piece length of type segments whose types have ``counts`` edges:
    the largest of :data:`SEGMENT_PIECES` that cuts them into at least
    :data:`SEGMENT_MIN_PIECES` pieces (a type of no edges is one piece), else
    the shortest. On FB15k-237's shape that is 256 for the entity graph
    (544,230 edges in 474 types) and 32 for the relation graph (about 31,700
    in 4 types): long pieces where there are edges enough to fill the card,
    short ones where there are not."""
    for piece in SEGMENT_PIECES:
        if int((-(-counts // piece)).clamp_min(1).sum()) >= SEGMENT_MIN_PIECES:
            return piece
    return SEGMENT_PIECES[-1]


@dataclasses.dataclass(frozen=True)
class TypeSegments:
    """Edges sorted by type (stable, so destination-major within a type),
    with a piece table over each type's run.

    ``etype``, ``src``, ``dst`` and ``eid`` are (E_live,) int32.

    The piece table, a :class:`CSR`'s with the type as the row (B2 and B5
    walk it): pieces of at most ``piece_len`` edges (:func:`segment_piece`),
    ``piece_ptr`` ... ``long_slot_ptr`` as in :class:`CSR`, so each of the
    ``num_types`` types has at least one piece (a type with no edges one of
    none) and ``long_rows`` are the types of more than one piece.

    The segments check their tensors' types, lengths and device when they
    are made, so the relation gradients' wrappers check only ``src``.
    """

    etype: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    eid: torch.Tensor
    piece_ptr: torch.Tensor
    piece_row: torch.Tensor
    piece_slot: torch.Tensor
    piece_order: torch.Tensor
    long_rows: torch.Tensor
    long_slot_ptr: torch.Tensor
    piece_len: int
    num_types: int

    def __post_init__(self):
        edges = self.src.numel()
        _check_fields(self, self.src, {
            "etype": (torch.int32, edges), "src": (torch.int32, edges),
            "dst": (torch.int32, edges), "eid": (torch.int32, edges)})

    @property
    def num_slots(self) -> int:
        """Partial rows of the long types' pieces, from the shapes alone."""
        return _num_slots(self, self.num_types)

    def to(self, device) -> "TypeSegments":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def build_segments(csr: CSR, num_types: int, piece_len: Optional[int] = None) -> TypeSegments:
    """The type segments of ``csr``'s edges, with their piece table (pieces
    of ``piece_len`` edges, by default :func:`segment_piece`'s).

    Many pieces per type let one type's edges spread over many groups of
    threads: the relation graph has 4 types, and a block per type would
    leave most of the card idle."""
    device = csr.col.device
    num_rows = csr.rowptr.numel() - 1
    dst = torch.repeat_interleave(
        torch.arange(num_rows, device=device), csr.rowptr.diff(),
        output_size=csr.col.numel(),
    )
    etype = csr.etype.long()
    order = torch.argsort(etype, stable=True)
    counts = torch.bincount(etype, minlength=num_types)
    type_ptr = torch.zeros(num_types + 1, dtype=torch.int64, device=device)
    type_ptr[1:] = torch.cumsum(counts, 0)
    if piece_len is None:
        piece_len = segment_piece(counts)
    return TypeSegments(
        etype=etype[order].to(torch.int32),
        src=csr.col[order],
        dst=dst[order].to(torch.int32),
        eid=csr.eid[order],
        **_pieces(type_ptr, counts, piece_len),
        piece_len=piece_len,
        num_types=num_types,
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
        **_pieces(rowptr, counts, ROW_PIECE),
    )


def _pieces(rowptr, counts, piece_len: int):
    """The piece table of rows with these pointers and lengths, cut into
    pieces of at most ``piece_len`` edges (the fields of :class:`CSR` from
    ``piece_ptr`` on)."""
    device = rowptr.device
    num_rows = counts.numel()
    pieces = (-(-counts // piece_len)).clamp_min(1)  # per row
    row_first = torch.cumsum(pieces, 0) - pieces  # each row's first piece
    num_pieces = int(pieces.sum())
    piece_row = torch.repeat_interleave(
        torch.arange(num_rows, device=device), pieces, output_size=num_pieces,
    )
    k = torch.arange(num_pieces, device=device) - row_first[piece_row]
    piece_ptr = torch.empty(num_pieces + 1, dtype=torch.int64, device=device)
    piece_ptr[:-1] = rowptr[piece_row] + piece_len * k
    piece_ptr[-1] = rowptr[-1]
    lengths = piece_ptr.diff()
    order = torch.sort(lengths, descending=True, stable=True).indices
    is_long = pieces > 1
    long_piece = is_long[piece_row]
    piece_slot = torch.where(long_piece, torch.cumsum(long_piece, 0) - 1, -1)
    long_slot_ptr = torch.zeros(int(is_long.sum()) + 1, dtype=torch.int64, device=device)
    long_slot_ptr[1:] = torch.cumsum(pieces[is_long], 0)
    return dict(
        piece_ptr=piece_ptr,
        piece_row=piece_row.to(torch.int32),
        piece_slot=piece_slot.to(torch.int32),
        piece_order=order.to(torch.int32),
        long_rows=torch.nonzero(is_long).flatten().to(torch.int32),
        long_slot_ptr=long_slot_ptr,
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

    ``edge_group`` is set on one block of a graph's edges split over the
    ranks of a process group (``parallel/mesh.py::shard_graph``): the convs
    then combine their partial aggregates over that group. None otherwise.
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
    edge_group: Optional[object] = None

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
