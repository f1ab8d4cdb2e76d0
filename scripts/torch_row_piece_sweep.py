"""How long the pieces of the rspmm forwards' rows should be: time B1 and
B3 on the card with ``graph.ROW_PIECE`` set to each of several sizes.

  python3 scripts/torch_row_piece_sweep.py [--pieces 32,64,128,256] [--out build/row_piece_sweep.json]

B1 (``csrc/rspmm_sum_fwd.cu``) and B3 (``csrc/rspmm_minmax_fwd.cu``) give
each piece of at most ``ROW_PIECE`` edges of a CSR row to its own group of
threads (``graph.py``, ``csrc/rspmm_pieces.cuh``). For each size this
builds, with that ``ROW_PIECE``, the FB15k-237-shaped graph (seed 0, with
its relation graph) and the graph with the same sources, types and edge
count and uniformly drawn destinations (``benchlib.uniform_destination_graph``),
and times (median device ms, ``benchlib.device_ms``) the launches of the
main paths on both: B1 on the entity graph at F = 512 (a batch of 8 at
D = 64), 64 (attribution) and 1024 (validation), its input gradient at
F = 512 (on the CSR by source; on the uniform graph the CSR by destination,
whose rows are short), B1 on the relation graph at F = 4096 (the
precompute) and 512, and B3 at F = 512. Before it is timed, each launch's
output is held against its plain version: B1 as ``chip_smoke.py`` holds
it (in f64, within 1e-5 of the sum of the absolute terms plus 1e-6), B3
equal; the script exits 1 if one is not. Needs one CUDA card; prints the
card's name and power limit first, then one JSON object, which ``--out``
also writes.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def held(fn, plain, csr, w, rel, x, exact):
    """Whether ``fn``'s output on these inputs agrees with ``plain``'s: equal
    (``exact``), or within ``chip_smoke.py``'s tolerance for a sum."""
    from chip_smoke import sum_kernel_error

    got = fn(csr, w, rel, x, "mul")
    if exact:
        return bool(torch.equal(got, plain(csr, w, rel, x, "mul")))
    return sum_kernel_error(got, plain, csr, w, rel, x, "mul")[-1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pieces", default="32,64,128,256",
                        help="comma-separated ROW_PIECE values")
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_row_piece_sweep: no CUDA device", file=sys.stderr)
        return 1

    from ultra_tpu_torch import graph as graph_module
    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.ops import build
    from ultra_tpu_torch.ops.rspmm_cuda import (
        rspmm_sum_dx, rspmm_sum_dx_plain, rspmm_sum_fwd, rspmm_sum_fwd_plain,
    )
    from ultra_tpu_torch.ops.rspmm_minmax_cuda import rspmm_minmax_fwd, rspmm_minmax_fwd_plain
    from ultra_tpu_torch.utils.benchlib import (
        device_ms, fb15k237_split, uniform_destination_graph,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    build.build_all(("rspmm_sum_fwd", "rspmm_minmax_fwd"))
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
    record = {"card": card, "device": torch.cuda.get_device_name(0), "sizes": {}}
    ok = True
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
            w = on.edge_weight * (torch.rand(on.edge_weight.shape, generator=gen) >= 0.1).cuda()
            rel, x = rand(on.num_relations, feat), rand(on.num_nodes, feat)
            w_u = uniform.edge_weight * (
                torch.rand(uniform.edge_weight.shape, generator=gen) >= 0.1).cuda()
            row = {"ok": held(fn, plain, csr, w, rel, x, exact),
                   "ms": device_ms(lambda: fn(csr, w, rel, x, "mul"))}
            if walked != "relation":
                row["uniform_ok"] = held(fn, plain, uniform.csr, w_u, rel, x, exact)
                row["uniform_ms"] = device_ms(lambda: fn(uniform.csr, w_u, rel, x, "mul"))
            ok &= row["ok"] and row.get("uniform_ok", True)
            size[name] = row
            print(f"[sweep] ROW_PIECE={piece} {name}: {json.dumps(row)}", flush=True)
        record["sizes"][piece] = size
        del graph, uniform
        torch.cuda.empty_cache()
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
