"""How wide B1's feature tiles should be where x does not fit the L2: time
B1 (``csrc/rspmm_sum_fwd.cu``) on the card at every tile it supports, and
name the tile ``rspmm_cuda.slab_tile`` chooses at several shares of the
card's L2, on the shapes of the benchmark's cells and of the paths that
share B1.

  python3 scripts/torch_slab_sweep.py [--shares 0.5,0.625,0.75]
      [--variants 2x4,4x4,stage4,ldcs] [--out build/slab_sweep.json]

The shapes (f32 unless named; the forward over the CSR by destination, the
input gradient, d_x, over the CSR by source):
- ``rank``: a YAGO3-10-sized graph (123,182 entities, 37 relations,
  1,079,040 triples, Zipf relations, 30 categories; the ranking cell's) at
  F = 1,024, a pass of 16 queries, in f32 and bf16;
- ``eval``: FB15k-237 as BetaE splits it (14,505 entities, 237
  relations, 248,063 triples both ways; the evaluation cell's) at F = 2,048;
- ``fb237``: ``benchlib.fb15k237_split`` at F = 512 and 1,024, d_x at 512,
  bf16 at 512 and 1,024, the bf16 input gradient at 512, and its relation
  graph at F = 4,096 (an x that fits: one geometry).

For each it times (median device ms, ``benchlib.device_ms``) every tile
that divides the row, whole rows included, each held bit for bit to the
whole-row walk's output; ``chosen`` maps each share to the tile the rule
takes there. ``--variants`` builds B1 again under ``build/slab_sweep/``
with the f32 instance's sizes in slabs (``UxB``: edges in flight, blocks
an SM; ``kSlabUnroll``, ``kSlabMinBlocks``), its staging loop unrolled 4
times (``stage4``) or its staged index loads marked evict-first (``ldcs``),
or several joined by ``+``, and times each at the tile of the first share
and, where that is not the whole row, at the whole row.
Needs one CUDA card; prints the card's name and power limit, one line a
timing, then the record as JSON, which ``--out`` also writes. Exits 1 if a
tile's output differs.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

ROOT = Path(__file__).resolve().parent.parent
ENTRIES = ("rspmm_sum_fwd", "rspmm_sum_fwd_bf16_bf16", "rspmm_sum_fwd_bf16_f32")
# the f32 instance's sizes in slabs, in csrc/rspmm_sum_fwd.cu
SLAB_SIZES = re.compile(r"kSlabUnroll = \d+, kSlabMinBlocks = \d+;")
STAGE_LOOP = "    for (int i = lane; i < n; i += group) W::stage(a, begin + base + i, s, i);"
STAGED_INDICES = ("__ldg(a.col + e)", "__ldg(a.etype + e)", "__ldg(a.eid + e)")


def edit_variant(name: str, source: str, header: str):
    """(``csrc/rspmm_sum_fwd.cu``, ``csrc/rspmm_pieces.cuh``) as texts with
    variant ``name`` applied (several joined by ``+``)."""
    if "+" in name:
        for part in name.split("+"):
            source, header = edit_variant(part, source, header)
        return source, header
    if re.fullmatch(r"\d+x\d+", name):
        u, b = name.split("x")
        source, n = SLAB_SIZES.subn(f"kSlabUnroll = {u}, kSlabMinBlocks = {b};", source)
    elif name == "stage4":
        n = header.count(STAGE_LOOP)
        header = header.replace(STAGE_LOOP, "#pragma unroll 4\n" + STAGE_LOOP)
    elif name == "ldcs":
        n = sum(header.count(s) for s in STAGED_INDICES)
        for s in STAGED_INDICES:
            header = header.replace(s, s.replace("__ldg", "__ldcs"))
        n = n if n == len(STAGED_INDICES) else 0
    else:
        raise ValueError(f"unknown variant {name!r}")
    if n < 1:
        raise RuntimeError(f"variant {name}: its pattern is not in csrc/")
    return source, header


def build_variants(names):
    """B1 built under build/slab_sweep/<name>/ for each variant: ({name:
    {entry point: bound C function}}, {name: the compiler's resource lines})."""
    from ultra_tpu_torch.ops import build, rspmm_cuda

    csrc = ROOT / "ultra_tpu_torch" / "csrc"
    procs = {}
    for name in names:
        d = ROOT / "build" / "slab_sweep" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        texts = edit_variant(name, (d / "rspmm_sum_fwd.cu").read_text(),
                             (d / "rspmm_pieces.cuh").read_text())
        for file, text in zip(("rspmm_sum_fwd.cu", "rspmm_pieces.cuh"), texts):
            (d / file).write_text(text)
        procs[name] = (d / "librspmm_sum_fwd.so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "librspmm_sum_fwd.so"),
             str(d / "rspmm_sum_fwd.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns, usage = {}, {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        usage[name] = build.ptxas_usage(log)
        cdll = ctypes.CDLL(str(lib))
        for entry in ENTRIES:
            fn = getattr(cdll, entry)
            fn.argtypes, fn.restype = rspmm_cuda._ARGTYPES["rspmm_sum_fwd"], ctypes.c_int
            fns.setdefault(name, {})[entry] = fn
    return fns, usage


def graphs():
    """The three graphs of the sweep, on the card: {name: Graph}."""
    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
    from ultra_tpu_torch.graph import make_graph
    from ultra_tpu_torch.utils.benchlib import fb15k237_split

    out = {}
    for name, nodes, rels, triples in (("rank", 123_182, 37, 1_079_040),
                                       ("eval", 14_505, 237, 248_063)):
        trip = random_kg_triples(nodes, rels, triples, seed=0, rel_dist="zipf", categories=30)
        ei, et = with_inverses(trip, rels)
        out[name] = make_graph(ei, et, nodes, 2 * rels, device="cuda")
    out["fb237"] = split_to_graph(fb15k237_split("realistic", seed=0), device="cuda")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shares", default="0.5,0.625,0.75",
                        help="comma-separated shares of the L2 a slab may fill")
    parser.add_argument("--variants", default="",
                        help="comma-separated builds of B1 to time beside the source's")
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()
    shares = [float(s) for s in args.shares.split(",") if s]
    variants = [v for v in args.variants.split(",") if v]
    if not torch.cuda.is_available():
        print("torch_slab_sweep: no CUDA device", file=sys.stderr)
        return 1

    from ultra_tpu_torch.ops import build, rspmm_cuda
    from ultra_tpu_torch.utils.benchlib import device_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    l2 = rspmm_cuda._l2_bytes(torch.device("cuda", torch.cuda.current_device()))
    record = {"card": card, "device": torch.cuda.get_device_name(0), "l2_bytes": l2,
              "ptxas": build.ptxas_usage(build.build_all(["rspmm_sum_fwd"]).get(
                  "rspmm_sum_fwd", "")), "cases": {}}
    variant_fns, record["variant_ptxas"] = build_variants(variants)
    g = graphs()
    fb = g["fb237"]
    gen = torch.Generator().manual_seed(0)
    # (case, graph, walked layout, F, relation type, x type)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = (
        ("rank/F1024", g["rank"], "csr", 1024, f32, f32),
        ("rank[bf16]/F1024", g["rank"], "csr", 1024, bf16, bf16),
        ("eval/F2048", g["eval"], "csr", 2048, f32, f32),
        ("fb237/F512", fb, "csr", 512, f32, f32),
        ("fb237/F1024", fb, "csr", 1024, f32, f32),
        ("fb237/dx/F512", fb, "csr_src", 512, f32, f32),
        ("fb237[bf16]/F512", fb, "csr", 512, bf16, bf16),
        ("fb237[bf16]/F1024", fb, "csr", 1024, bf16, bf16),
        ("fb237[bf16]/dx/F512", fb, "csr_src", 512, bf16, f32),
        ("fb237/relation/F4096", fb.relation_graph, "csr", 4096, f32, f32),
    )
    ok = True
    for label, on, walked, feat, rel_type, x_type in cases:
        csr = getattr(on, walked)
        rel = torch.randn(on.num_relations, feat, generator=gen).to("cuda", rel_type)
        x = torch.randn(on.num_nodes, feat, generator=gen).to("cuda", x_type)
        w = torch.rand(on.edge_weight.shape, generator=gen).cuda() * on.edge_weight
        name = rspmm_cuda._entry("rspmm_sum_fwd", rspmm_cuda._instance("sweep", "rspmm_sum_fwd",
                                                                         rel, x))
        features = rspmm_cuda._FEATURES.get(name, 4)
        width = feat // features
        whole = rspmm_cuda.group_size(width)
        chosen = {s: rspmm_cuda.slab_tile(x.shape[0], feat, x.element_size(), features,
                                          int(s * l2)) for s in shares}
        tiles = [t for t in (8, 16, *range(32, 257, 32)) if t <= width and width % t == 0]
        tiles = sorted(set(tiles) | {whole})

        def launch(tile):
            return rspmm_cuda._launch_pieces(name, "sweep", csr, w, rel, x, 0, tile)

        want = launch(whole)
        row = {"rows": on.num_nodes, "edges": csr.col.numel(), "entry": name, "whole": whole,
               "x_bytes": x.numel() * x.element_size(),
               "chosen": {str(s): t for s, t in chosen.items()}, "ms": {}, "equal": {}}
        for tile in tiles:
            row["equal"][tile] = bool(torch.equal(launch(tile), want))
            row["ms"][tile] = device_ms(lambda: launch(tile))
            ok &= row["equal"][tile]
            print(f"[slab] {label} tile {tile}{' (whole)' if tile == whole else ''}: "
                  f"{row['ms'][tile]:.4f} ms, equal {row['equal'][tile]}", flush=True)
        own = rspmm_cuda._KERNELS.get(name)
        for variant, fns in variant_fns.items():
            rspmm_cuda._KERNELS[name] = fns[name]
            for tile in sorted({whole, chosen[shares[0]]} if shares else {whole}):
                if tile == whole and variant[0].isdigit() and chosen.get(shares[0]) != whole:
                    continue  # the sizes in slabs leave the whole rows' walk alone
                same = bool(torch.equal(launch(tile), want))
                ms = device_ms(lambda: launch(tile))
                ok &= same
                row.setdefault("variants", {}).setdefault(variant, {})[tile] = {
                    "ms": ms, "equal": same}
                print(f"[slab] {label} {variant} tile {tile}: {ms:.4f} ms, equal {same}",
                      flush=True)
        rspmm_cuda._KERNELS[name] = own
        record["cases"][label] = row
        del rel, x, w, want
        torch.cuda.empty_cache()

    print(json.dumps(record, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if not ok:
        print("torch_slab_sweep: a tile's output differs from the whole row's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
