"""How long the pieces of the rspmm walks should be: time B1, B3, B4 and B6
on the card with ``graph.ROW_PIECE`` set to each of several sizes, and B2
and B5 with the type segments cut into pieces of each of several lengths.

  python3 scripts/torch_row_piece_sweep.py [--pieces 32,64,128,256]
      [--segment-pieces 32,64,128,256] [--dw-parts 1,2,4]
      [--out build/row_piece_sweep.json]

B1 (``csrc/rspmm_sum_fwd.cu``), B3 (``csrc/rspmm_minmax_fwd.cu``) and B4
(``csrc/rspmm_minmax_dx.cu``) give each piece of at most ``ROW_PIECE`` edges
of a CSR row to its own group of threads (``graph.py``,
``csrc/rspmm_pieces.cuh``). For each size this builds, with that
``ROW_PIECE``, the FB15k-237-shaped graph (seed 0, with its relation graph)
and the graph with the same sources, types and edge count and uniformly
drawn destinations (``benchlib.uniform_destination_graph``), and times
(median device ms, ``benchlib.device_ms``) the launches of the main paths on
both: B1 on the entity graph at F = 512 (a batch of 8 at D = 64), 64
(attribution) and 1024 (validation), its input gradient at F = 512 (on the
CSR by source; on the uniform graph the CSR by destination, whose rows are
short), B1 on the relation graph at F = 4096 (the precompute) and 512, B3
and B4 at F = 512 (B4 given B3's output), and B6 (``csrc/rspmm_dw.cu``,
which walks the same pieces with a pass of its own) at F = 64
(attribution; the sum, on both graphs) and 512 (min/max, given B3's
output). B6 may split each piece over several groups
(``rspmm_cuda.DW_PARTS``): at the default ``ROW_PIECE`` it is timed the
same way for each count of ``--dw-parts``.

B2 (``csrc/rspmm_sum_drel.cu``) and B5 (``csrc/rspmm_minmax_drel.cu``)
walk the type segments' pieces (``graph.segment_piece`` chooses their
length). For each length of ``--segment-pieces`` it rebuilds both graphs'
segments with pieces of that length and times B2 (mul) and B5 (mul, max,
given B3's output) at F = 512 on each.

Before it is timed, each launch's output is held against its plain version:
B1 and B2 as ``chip_smoke.py`` holds them (in f64, within 1e-5 of the sum of
the absolute terms plus 1e-6), B3 equal, B4, B5 and B6 against plain
versions routed in f32 and added in f64 within the same tolerance; the
script exits 1 if one is not. Needs one CUDA card; prints the card's name and power limit first,
then one JSON object (with the compiler's resource lines of each kernel),
which ``--out`` also writes.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

SOURCES = ("rspmm_sum_fwd", "rspmm_sum_drel", "rspmm_minmax_fwd", "rspmm_minmax_dx",
           "rspmm_minmax_drel", "rspmm_dw")


def held(fn, plain, csr, w, rel, x, exact):
    """Whether ``fn``'s output on these inputs agrees with ``plain``'s: equal
    (``exact``), or within ``chip_smoke.py``'s tolerance for a sum."""
    from chip_smoke import sum_kernel_error

    got = fn(csr, w, rel, x, "mul")
    if exact:
        return bool(torch.equal(got, plain(csr, w, rel, x, "mul")))
    return sum_kernel_error(got, plain, csr, w, rel, x, "mul")[-1]


def minmax_dx_launch(forward_csr, csr_src, w, rel, x, g):
    """(held, launch) of B4 over ``csr_src``, routing against B3's output
    over ``forward_csr``."""
    from chip_smoke import minmax_grad_error
    from ultra_tpu_torch.ops.rspmm_minmax_cuda import (
        rspmm_minmax_dx, rspmm_minmax_dx_terms, rspmm_minmax_fwd,
    )

    out = rspmm_minmax_fwd(forward_csr, w, rel, x)
    got = rspmm_minmax_dx(csr_src, w, rel, x, g, out)
    ok = minmax_grad_error(got, rspmm_minmax_dx_terms, csr_src, w, rel, x, g, out, "mul",
                           x.shape[0])[2]
    return ok, lambda: rspmm_minmax_dx(csr_src, w, rel, x, g, out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pieces", default="32,64,128,256",
                        help="comma-separated ROW_PIECE values")
    parser.add_argument("--segment-pieces", default="32,64,128,256",
                        help="comma-separated piece lengths of the type segments")
    parser.add_argument("--dw-parts", default="1,2,4",
                        help="comma-separated counts of groups B6 splits a piece over")
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_row_piece_sweep: no CUDA device", file=sys.stderr)
        return 1

    from ultra_tpu_torch import graph as graph_module
    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.graph import build_segments
    from ultra_tpu_torch.ops import build
    from chip_smoke import dw_error, minmax_grad_error
    from ultra_tpu_torch.ops import rspmm_cuda
    from ultra_tpu_torch.ops.rspmm_cuda import (
        rspmm_dw, rspmm_sum_drel, rspmm_sum_drel_plain, rspmm_sum_dx, rspmm_sum_dx_plain,
        rspmm_sum_fwd, rspmm_sum_fwd_plain,
    )
    from ultra_tpu_torch.ops.rspmm_minmax_cuda import (
        rspmm_minmax_drel, rspmm_minmax_drel_terms, rspmm_minmax_fwd, rspmm_minmax_fwd_plain,
    )
    from ultra_tpu_torch.utils.benchlib import (
        device_ms, fb15k237_split, uniform_destination_graph,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    record = {"card": card, "device": torch.cuda.get_device_name(0), "sizes": {},
              "segment_sizes": {}, "dw_parts": {}, "ptxas": {name: build.ptxas_usage(log) for name, log in
                                             build.build_all(SOURCES).items()}}
    split = fb15k237_split("realistic", seed=0)
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=gen).cuda()
    launches = (  # (name, function, plain version, graph -> CSR walked, F, exact)
        ("rspmm_sum_fwd/entity/F512", rspmm_sum_fwd, rspmm_sum_fwd_plain, "csr", 512, False),
        ("rspmm_sum_fwd/entity/F64", rspmm_sum_fwd, rspmm_sum_fwd_plain, "csr", 64, False),
        ("rspmm_sum_fwd/entity/F1024", rspmm_sum_fwd, rspmm_sum_fwd_plain, "csr", 1024, False),
        ("rspmm_sum_dx/entity/F512", rspmm_sum_dx, rspmm_sum_dx_plain, "csr_src", 512, False),
        ("rspmm_sum_fwd/relation/F4096", rspmm_sum_fwd, rspmm_sum_fwd_plain, "relation", 4096,
         False),
        ("rspmm_sum_fwd/relation/F512", rspmm_sum_fwd, rspmm_sum_fwd_plain, "relation", 512,
         False),
        ("rspmm_minmax_fwd/entity/F512", rspmm_minmax_fwd, rspmm_minmax_fwd_plain, "csr", 512,
         True),
    )
    ok = True

    def masked(weight):
        return weight * (torch.rand(weight.shape, generator=gen) >= 0.1).cuda()

    def time_minmax_dx(graph, uniform, feat=512):
        """B4 at ``feat`` on ``graph``'s CSR by source and on ``uniform``'s
        CSR by destination (as the CSR by source of the transposed graph)."""
        rel, x, g = rand(graph.num_relations, feat), rand(graph.num_nodes, feat), rand(
            graph.num_nodes, feat)
        w, w_u = masked(graph.edge_weight), masked(uniform.edge_weight)
        row_ok, fn = minmax_dx_launch(graph.csr, graph.csr_src, w, rel, x, g)
        uniform_ok, fn_u = minmax_dx_launch(uniform.csr_src, uniform.csr, w_u, rel, x, g)
        return {"ok": row_ok, "ms": device_ms(fn), "uniform_ok": uniform_ok,
                "uniform_ms": device_ms(fn_u)}

    def time_drel(graph, seg, feat=512):
        x, g, w = rand(graph.num_nodes, feat), rand(graph.num_nodes, feat), masked(
            graph.edge_weight)
        return {"ok": held(rspmm_sum_drel, rspmm_sum_drel_plain, seg, w, x, g, False),
                "ms": device_ms(lambda: rspmm_sum_drel(seg, w, x, g)),
                "piece_len": seg.piece_len, "pieces": seg.piece_row.numel(),
                "long_types": seg.long_rows.numel(), "slots": seg.num_slots}

    def time_minmax_drel(graph, seg, feat=512):
        """B5 (mul, max) at ``feat`` over ``seg``, routing against B3's output."""
        rel, x, g = rand(graph.num_relations, feat), rand(graph.num_nodes, feat), rand(
            graph.num_nodes, feat)
        w = masked(graph.edge_weight)
        out = rspmm_minmax_fwd(graph.csr, w, rel, x)
        got = rspmm_minmax_drel(seg, w, rel, x, g, out)
        row_ok = minmax_grad_error(got, rspmm_minmax_drel_terms, seg, w, rel, x, g, out, "mul",
                                   graph.num_relations)[2]
        return {"ok": row_ok, "ms": device_ms(lambda: rspmm_minmax_drel(seg, w, rel, x, g, out)),
                "piece_len": seg.piece_len, "pieces": seg.piece_row.numel()}

    def time_dw(on, feat, minmax):
        """B6 at ``feat`` over ``on``'s CSR: the sum's, or (``minmax``) the
        max's given B3's output."""
        rel, x, g = rand(on.num_relations, feat), rand(on.num_nodes, feat), rand(on.num_nodes,
                                                                                 feat)
        w = masked(on.edge_weight)
        out = rspmm_minmax_fwd(on.csr, w, rel, x) if minmax else None
        row_ok = dw_error(rspmm_dw(on.csr, w, rel, x, g, "mul", out), on.csr, w, rel, x, g,
                          "mul", out)[2]
        return row_ok, device_ms(lambda: rspmm_dw(on.csr, w, rel, x, g, "mul", out))

    default_piece = graph_module.ROW_PIECE
    for piece in (int(p) for p in args.pieces.split(",")):
        graph_module.ROW_PIECE = piece  # read by build_csr when the graphs are built
        graph = split_to_graph(split, device="cuda")
        uniform = uniform_destination_graph(split)
        size = {"pieces": graph.csr.piece_row.numel(), "long_rows": graph.csr.long_rows.numel(),
                "slots": graph.csr.num_slots,
                "pieces_by_source": graph.csr_src.piece_row.numel(),
                "relation_pieces": graph.relation_graph.csr.piece_row.numel(),
                "uniform_pieces": uniform.csr.piece_row.numel()}
        for name, fn, plain, walked, feat, exact in launches:
            on = graph.relation_graph if walked == "relation" else graph
            csr = on.csr_src if walked == "csr_src" else on.csr
            w = masked(on.edge_weight)
            rel, x = rand(on.num_relations, feat), rand(on.num_nodes, feat)
            w_u = masked(uniform.edge_weight)
            row = {"ok": held(fn, plain, csr, w, rel, x, exact),
                   "ms": device_ms(lambda: fn(csr, w, rel, x, "mul"))}
            if walked != "relation":
                row["uniform_ok"] = held(fn, plain, uniform.csr, w_u, rel, x, exact)
                row["uniform_ms"] = device_ms(lambda: fn(uniform.csr, w_u, rel, x, "mul"))
            ok &= row["ok"] and row.get("uniform_ok", True)
            size[name] = row
            print(f"[sweep] ROW_PIECE={piece} {name}: {json.dumps(row)}", flush=True)
        row = size["rspmm_minmax_dx/entity/F512"] = time_minmax_dx(graph, uniform)
        ok &= row["ok"] and row["uniform_ok"]
        print(f"[sweep] ROW_PIECE={piece} rspmm_minmax_dx/entity/F512: {json.dumps(row)}",
              flush=True)
        for name, feat, minmax in (("rspmm_dw/entity/F64", 64, False),
                                   ("rspmm_dw_minmax/entity/F512", 512, True)):
            row = dict(zip(("ok", "ms"), time_dw(graph, feat, minmax)))
            row.update(zip(("uniform_ok", "uniform_ms"), time_dw(uniform, feat, minmax)))
            ok &= row["ok"] and row["uniform_ok"]
            size[name] = row
            print(f"[sweep] ROW_PIECE={piece} {name}: {json.dumps(row)}", flush=True)
        record["sizes"][piece] = size
        del graph, uniform
        torch.cuda.empty_cache()

    graph_module.ROW_PIECE = default_piece
    graph = split_to_graph(split, device="cuda")
    uniform = uniform_destination_graph(split)
    default_parts = rspmm_cuda.DW_PARTS
    for parts in (int(p) for p in args.dw_parts.split(",")):
        rspmm_cuda.DW_PARTS = parts  # read by the wrapper at each launch
        size = record["dw_parts"][parts] = {}
        for name, feat, minmax in (("rspmm_dw/entity/F64", 64, False),
                                   ("rspmm_dw_minmax/entity/F512", 512, True)):
            row = dict(zip(("ok", "ms"), time_dw(graph, feat, minmax)))
            row.update(zip(("uniform_ok", "uniform_ms"), time_dw(uniform, feat, minmax)))
            ok &= row["ok"] and row["uniform_ok"]
            size[name] = row
            print(f"[sweep] DW_PARTS={parts} {name}: {json.dumps(row)}", flush=True)
    rspmm_cuda.DW_PARTS = default_parts
    for length in (int(p) for p in args.segment_pieces.split(",")):
        size = {}
        for tag, on in (("entity", graph), ("relation", graph.relation_graph)):
            seg = build_segments(on.csr, on.num_relations, piece_len=length)
            for name, timed in ((f"rspmm_sum_drel/{tag}/F512", time_drel),
                                (f"rspmm_minmax_drel/{tag}/F512", time_minmax_drel)):
                row = size[name] = timed(on, seg)
                ok &= row["ok"]
                print(f"[sweep] segment piece {length} {name}: {json.dumps(row)}", flush=True)
        record["segment_sizes"][length] = size

    print(json.dumps(record, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if not ok:
        print("torch_row_piece_sweep: a kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
