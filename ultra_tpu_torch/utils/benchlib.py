"""Device timing, kernel bounds, the benchmark graph, the PNA configuration
and the gather probe, for measurements on the card.

Counterpart of ``ultra_tpu/utils/benchlib.py`` and of the graph construction in
the root ``bench.py``. Used by ``chip_smoke.py`` and ``scripts/torch_*.py``;
nothing on the serving path imports it.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from ultra_tpu_torch.data.kg import KGSplit
from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.models.nbfnet import NBFNetConfig, UltraConfig

# FB15k-237 shape: 14,541 entities; 272,115 train triples (544,230 edges with
# inverses); 237 direct relations, 474 with inverses.
FB15K237_NODES, FB15K237_TRIPLES, FB15K237_DIRECT_REL = 14541, 272115, 237

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit):
# HBM3 bandwidth, and f32 outside the tensor cores, which is the arithmetic
# of the rspmm.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


def fb15k237_split(kind: str = "realistic", seed: int = 0) -> KGSplit:
    """The FB15k-237-shaped synthetic graph of ``bench.py``: power-law
    entity popularity; ``"realistic"`` adds Zipf relation frequencies and 30
    entity categories, ``"uniform"`` draws relations uniformly. The targets
    are the direct triples."""
    kw = dict(rel_dist="zipf", categories=30) if kind == "realistic" else {}
    trip = random_kg_triples(FB15K237_NODES, FB15K237_DIRECT_REL, FB15K237_TRIPLES,
                             seed=seed, **kw)
    edge_index, edge_type = with_inverses(trip, FB15K237_DIRECT_REL)
    return KGSplit(edge_index, edge_type, FB15K237_NODES, 2 * FB15K237_DIRECT_REL,
                   np.ascontiguousarray(trip[:, :2].T), trip[:, 2].copy())


def uniform_destination_graph(split: KGSplit, device="cuda", seed: int = 1):
    """A graph with ``split``'s sources, types and edge count and with
    destinations drawn uniformly (numpy, ``seed``): its rows are all short
    (the longest about 65 edges on FB15k-237's shape, against 3,031), so an
    rspmm walk's time on it is what the walk costs without hub rows."""
    from ultra_tpu_torch.graph import make_graph

    edge_index = split.edge_index.copy()
    edge_index[0] = np.random.default_rng(seed).integers(0, split.num_nodes,
                                                         edge_index.shape[1])
    return make_graph(edge_index, split.edge_type, split.num_nodes, split.num_relations,
                      device=device)


def pna_config() -> UltraConfig:
    """The PNA configuration at ``ultra_3g`` widths
    (``scripts/exp_pna_train.py:81-88``): a 6x64 sum RelNBFNet and a 6x64
    EntityNBFNet with projected relations, distmult messages and PNA
    aggregation, whose layers' ``linear`` takes 13 * 64 features."""
    dims = (64,) * 6
    return UltraConfig(
        relation_model=NBFNetConfig(input_dim=64, hidden_dims=dims, num_relation=4),
        entity_model=NBFNetConfig(input_dim=64, hidden_dims=dims, num_relation=1,
                                  project_relations=True, aggregate_func="pna"),
    )


def device_ms(fn, samples: int = 20, inner: int = 10) -> float:
    """Median device milliseconds per call of ``fn`` over ``samples`` runs
    of ``inner`` calls each, after warm-up, timed with CUDA events.

    A sleep kernel queued ahead of each run lets the host enqueue all
    ``inner`` calls before the first starts, so the events time the device
    and not the Python that launches the work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time of a kernel that moves
    ``nbytes`` and does ``flops`` f32 operations, the larger of the bytes
    over the card's memory rate and the operations over its f32 rate."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def live_edges(edge_weight, eid):
    """How many of the edges ``eid`` have a weight other than 0."""
    return int((edge_weight[eid.long()] != 0).sum())


def tensor_bytes(*tensors) -> int:
    """Bytes the tensors hold: a bf16 row counts 2 bytes an element."""
    return sum(t.numel() * t.element_size() for t in tensors)


def rspmm_bound_ms(csr, edge_weight, relation, x, mul="mul"):
    """Least time for one sum (or min/max) rspmm on these inputs: each input
    read once (x and relation at their own element size, the CSR and the
    weight of each CSR edge), the f32 output written once, and 3 f32
    operations per feature of each edge whose weight is not 0."""
    num_rows, feat = csr.rowptr.numel() - 1, x.shape[1]
    nbytes = tensor_bytes(x, relation) + 4 * num_rows * feat
    nbytes += 8 * (num_rows + 1) + (4 + 4 + 4 + 4) * csr.col.numel()
    return bound_ms(nbytes, 3 * live_edges(edge_weight, csr.eid) * feat)


def gather_bound_ms(x, idx):
    """Least time for one gather of ``x`` by ``idx`` (one output element per
    index for the lane gather, one row per index for the row gather): x and
    the indices read once, the output written once; no arithmetic."""
    out_numel = idx.numel() * (x.shape[1] if idx.dim() == 1 else 1)
    return bound_ms((x.numel() + out_numel) * x.element_size() + 4 * idx.numel(), 0)


# the shapes of the TPU gather probes (scripts/exp_dma_gather.py and
# aot_compile_probe.py): FB15k-237's entities at F=512, padded edges, bf16;
# the lane gather's (512, 128)
PROBE_V, PROBE_F, PROBE_E, LANE_SHAPE = 14541, 512, 616448, (512, 128)


def gather_probe(graph, seed=0):
    """The TPU gather probes' questions answered on the card: G1 (the row
    gather) at the probes' shape in bf16 and f32, G2 (the lane gather) at
    (512, 128) in f32 and bf16, and the share of a sum rspmm (B1 at F=512 on
    ``graph``, the FB15k-237-shaped entity graph) that gathering its source
    rows would take: G1 over the CSR's sources in f32 against B1.

    Each gather's output must equal its plain version's (``gather_cuda``),
    value for value. Each time (median device ms, :func:`device_ms`) stands
    beside its bound, its plain version's and that of the PyTorch call that
    computes the same function with int64 indices (``index_select``,
    ``gather``), which nothing in the package calls. G2's also beside
    ``launch_floor_ms``, an empty kernel's on G2's grid
    (``gather_cuda.gather_lanes_floor``), ``flat_grid_floor_ms``, an empty
    kernel's on the grid G2 took before its redesign (256 blocks of 256
    threads at (512, 128)), ``index_only_ms``, G2's walk storing its indices
    (``gather_cuda.gather_lanes_indices``, checked bit for bit), and
    ``by_lanes``, G2 and its floor at each of 2, 4 and 8 lanes a thread
    (each output equal to the plain version's). Returns the record:
    ``"gathers"`` maps a name to its row (``out_key``, the launch counter's
    key of its output), ``"equal"`` says whether every output equalled its
    plain version's."""
    from ultra_tpu_torch.ops.gather_cuda import (
        LANES_PER_THREAD, _key, gather_lanes, gather_lanes_floor, gather_lanes_indices,
        gather_lanes_plain, gather_rows, gather_rows_plain, launch_empty,
    )
    from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_fwd

    gen = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, generator=gen).cuda()
    rows = {}

    def row(name, replaces, kernel, plain, library, x, idx, dim):
        got, want = kernel(x, idx), plain(x, idx)
        equal = got.shape == want.shape and bool(torch.equal(got, want))
        long_idx = idx.long()
        least_ms, bound_by = gather_bound_ms(x, idx)
        rows[name] = {
            "replaces": replaces, "out_key": list(_key(got)), "equal": equal,
            "max_abs_err": 0.0 if equal else None,
            "ms": device_ms(lambda: kernel(x, idx)), "plain_ms": device_ms(lambda: plain(x, idx)),
            "library_ms": device_ms(lambda: library(x, dim, long_idx)),
            "library_call": f"torch.{library.__name__} (int64 indices)",
            "bound_ms": least_ms, "bound_by": bound_by,
        }
        return rows[name]["ms"]

    idx = torch.randint(0, PROBE_V, (PROBE_E,), generator=gen, dtype=torch.int32).cuda()
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        row(f"gather_rows/{tag}/V{PROBE_V}xF{PROBE_F}/E{PROBE_E}",
            "scripts/exp_dma_gather.py:94", gather_rows, gather_rows_plain, torch.index_select,
            rand(PROBE_V, PROBE_F).to(dtype), idx, 0)
    lane_idx = torch.randint(0, LANE_SHAPE[1], LANE_SHAPE, generator=gen,
                             dtype=torch.int32).cuda()
    # the grid G2 took before its redesign: a thread an element, 256 a block
    flat_grid = (min(-(-lane_idx.numel() // 256), 132 * 16), 256, 1)
    for dtype, tag, bits in ((torch.float32, "f32", torch.int32),
                             (torch.bfloat16, "bf16", torch.int16)):
        name = f"gather_lanes/{tag}/{LANE_SHAPE[0]}x{LANE_SHAPE[1]}"
        x = rand(*LANE_SHAPE).to(dtype)
        row(name, "scripts/aot_compile_probe.py:126", gather_lanes, gather_lanes_plain,
            torch.gather, x, lane_idx, 1)
        want = gather_lanes_plain(x, lane_idx)
        by_lanes = {}
        for lanes in (2, 4, 8):
            by_lanes[lanes] = {
                "equal": bool(torch.equal(gather_lanes(x, lane_idx, lanes), want)),
                "ms": (rows[name]["ms"] if lanes == LANES_PER_THREAD
                       else device_ms(lambda: gather_lanes(x, lane_idx, lanes))),
                "floor_ms": device_ms(lambda: gather_lanes_floor(x, lane_idx, lanes)),
            }
        indices = gather_lanes_indices(lane_idx, dtype)
        rows[name].update(
            lanes=LANES_PER_THREAD, by_lanes=by_lanes,
            launch_floor_ms=by_lanes[LANES_PER_THREAD]["floor_ms"],
            flat_grid_floor_ms=device_ms(lambda: launch_empty(x.device, *flat_grid)),
            index_only_ms=device_ms(lambda: gather_lanes_indices(lane_idx, dtype)),
            index_only_equal=bool(torch.equal(indices.view(bits), lane_idx.to(bits))))
        rows[name]["equal"] &= rows[name]["index_only_equal"] and all(
            r["equal"] for r in by_lanes.values())

    feat, csr = PROBE_F, graph.csr
    rel, x = rand(graph.num_relations, feat), rand(graph.num_nodes, feat)
    b1_ms = device_ms(lambda: rspmm_sum_fwd(csr, graph.edge_weight, rel, x, "mul"))
    b1_bound = rspmm_bound_ms(csr, graph.edge_weight, rel, x)
    src_ms = row(f"gather_rows/f32/sources/E{csr.col.numel()}", "scripts/exp_v2proto.py:69",
                 gather_rows, gather_rows_plain, torch.index_select, x, csr.col, 0)
    return {"gathers": rows, "equal": all(r["equal"] for r in rows.values()),
            f"rspmm_sum_fwd/entity/F{feat}": {"ms": b1_ms, "bound_ms": b1_bound[0],
                                              "bound_by": b1_bound[1]},
            "source_gather_share_of_rspmm": src_ms / b1_ms}
