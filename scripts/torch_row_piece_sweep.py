"""How long the pieces of the rspmm walks should be: time B1, B3, B4 and B6
on the card with ``graph.ROW_PIECE`` set to each of several sizes, and B2
and B5 with the type segments cut into pieces of each of several lengths.

  python3 scripts/torch_row_piece_sweep.py [--pieces 32,64,128,256]
      [--segment-pieces 32,64,128,256] [--dw-parts 1,2,4]
      [--walk8 2x2,4x4,8x2] [--out build/row_piece_sweep.json]

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

At the default pieces it times the bf16 instances, which walk 8 features
a thread (``csrc/rspmm_pieces.cuh``: B1's ``rspmm_sum_fwd_bf16_bf16`` on
the entity graph at F = 512 and the relation graph at 512 and 4096, its
input gradient ``rspmm_sum_fwd_bf16_f32`` on both graphs at 512, B2's
``rspmm_sum_drel_bf16`` on both at 512, B3's ``rspmm_minmax_fwd_bf16_bf16``,
B4's ``rspmm_minmax_dx_bf16_bf16`` and B5's ``rspmm_minmax_drel_bf16_bf16``
(mul, max; B4 and B5 given B3's output) at 512, and B6's
``rspmm_dw_bf16_bf16`` (the sum) at 64, each on the entity graph and on the
uniform graph's short rows) beside the f32 instance on the same values
widened to f32 (``f32_ms``), with ``f32_equal``, the largest difference
between the two outputs. ``--walk8`` takes sizes of that walk, each
``UNROLLxBLOCKS`` (edges whose loads a thread keeps in flight, blocks an SM
must hold): for each it copies ``csrc/`` under ``build/walk8/`` with every
size pair of the walk (``WALK8_SIZES``: B1's ``kGather8Unroll``/
``kGather8MinBlocks`` and ``kGather8F32...``, B2's ``kDrel8...``, B3's
``kMinmax8...``, B4's ``kDx8...``, B5's ``kMinmaxDrel8...``, B6's
``kDw8...``) set so, builds the six sources, one ``nvcc`` each, all at
once, and times the same launches through it, the source's own build first
and last. It also counts, in the SASS of each pass-1 kernel of B1-B6
(``cuobjdump -sass``), the instructions that widen a bf16 value (a mask
with 0xffff0000, a shift by 16), conversions (``F2F``, ``PRMT``) and the
f32 arithmetic. An empty list skips a sweep.

Before it is timed, each launch's output is held against its plain version:
B1 and B2 as ``chip_smoke.py`` holds them (in f64, within 1e-5 of the sum of
the absolute terms plus 1e-6), B3 equal, B4, B5 and B6 against plain
versions routed in f32 and added in f64 within the same tolerance; the
script exits 1 if one is not. Needs one CUDA card; prints the card's name and power limit first,
then one JSON object (with the compiler's resource lines of each kernel),
which ``--out`` also writes.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

SOURCES = ("rspmm_sum_fwd", "rspmm_sum_drel", "rspmm_minmax_fwd", "rspmm_minmax_dx",
           "rspmm_minmax_drel", "rspmm_dw")


ROOT = Path(__file__).resolve().parent.parent
# the sources of the 8-feature walk (B1-B6: every rspmm source) and its C
# entry points (every bf16 instance)
WALK8_SOURCES = SOURCES
WALK8_ENTRIES = ("rspmm_sum_fwd_bf16_bf16", "rspmm_sum_fwd_bf16_f32", "rspmm_sum_drel_bf16",
                 "rspmm_minmax_fwd_bf16_bf16", "rspmm_minmax_dx_bf16_bf16",
                 "rspmm_minmax_drel_bf16_bf16", "rspmm_dw_bf16_bf16")
# a size pair of the 8-feature walk in a source: "kNameUnroll = U, kNameMinBlocks = B"
WALK8_PATTERN = re.compile(r"(k\w+8\w*)Unroll = \d+, \1MinBlocks = \d+")
# the size pairs each file of csrc/ holds, by name (B1's sizes sit in the header)
WALK8_SIZES = {"rspmm_pieces.cuh": ("kGather8", "kGather8F32"), "rspmm_sum_fwd.cu": (),
               "rspmm_sum_drel.cu": ("kDrel8",), "rspmm_minmax_fwd.cu": ("kMinmax8",),
               "rspmm_minmax_dx.cu": ("kDx8",), "rspmm_minmax_drel.cu": ("kMinmaxDrel8",),
               "rspmm_dw.cu": ("kDw8",)}
# the policies of the 8-feature walk, as they appear in its kernels' names
# (MinMaxDrel8 holds Drel8), and B6's own 8-feature pass
WALK8_POLICIES = ("Gather8", "Drel8", "Dx8", "dw8_kernel")
# the pass-1 kernels whose SASS is counted: the piece walk's, B6's two passes
PASS1_KERNELS = re.compile(r"piece_kernel|dw8?_kernel")


def ints(text):
    """A comma-separated list of ints; an empty one is []."""
    return [int(p) for p in text.split(",") if p]


def build_walk8(sizes):
    """The 8-feature walk's sources (B1-B6) with its sizes set to each
    (unroll, blocks) of ``sizes``, copied under build/walk8/<u>x<b>/ and
    built there, one nvcc per source, all at once. Returns ({(u, b): {entry
    point: bound C function}}, {"<u>x<b>": the compiler's resource lines of
    the walk's kernels})."""
    from ultra_tpu_torch.ops import build

    csrc = ROOT / "ultra_tpu_torch" / "csrc"
    procs = {}
    for u, b in sizes:
        d = ROOT / "build" / "walk8" / f"{u}x{b}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        for name, pairs in WALK8_SIZES.items():
            text, n = WALK8_PATTERN.subn(rf"\1Unroll = {u}, \1MinBlocks = {b}",
                                         (d / name).read_text())
            if n != len(pairs):
                raise RuntimeError(f"{name}: {n} sizes of the 8-feature walk, want {len(pairs)}")
            (d / name).write_text(text)
        for src in WALK8_SOURCES:
            procs[(u, b), src] = (d / f"lib{src}.so", subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / f"lib{src}.so"),
                 str(d / f"{src}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    fns, usage = {}, {}
    for (size, src), (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src} at {size}:\n{log}")
        usage.setdefault("x".join(map(str, size)), []).extend(
            u for u in build.ptxas_usage(log) if any(p in u for p in WALK8_POLICIES))
        cdll = ctypes.CDLL(str(lib))
        for entry in WALK8_ENTRIES:
            if entry.startswith(src + "_"):
                fns.setdefault(size, {})[entry] = build.bind(entry, cdll)
    return fns, usage


def sass_counts(library):
    """For each pass-1 kernel (``PASS1_KERNELS``) in ``library``'s SASS: its
    instructions in all, the bf16 widenings (a mask with 0xffff0000; a
    shift by 16, as SHF by 0x10 or IMAD by 0x10000), the conversions (F2F,
    PRMT) and the f32 FFMA and FMUL."""
    from ultra_tpu_torch.ops import build

    cuobjdump = shutil.which("cuobjdump") or str(Path(build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            name = name if PASS1_KERNELS.search(name) else None
            if name:
                counts[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*);", line)
        if not (name and m):
            continue
        op, args = m.group(1), m.group(2)
        base, c = op.split(".")[0], counts[name]
        c["total"] += 1
        c["mask_ffff0000"] += "0xffff0000" in args
        c["shift_16"] += (op.startswith("SHF.L") and ", 0x10," in args) or (
            base == "IMAD" and "0x10000," in args)
        c["conversion"] += base in ("F2F", "PRMT")
        if base in ("FFMA", "FMUL", "LDG"):
            c[base] += 1
    return {name: dict(c) for name, c in counts.items()}


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
    parser.add_argument("--walk8", default="",
                        help="comma-separated UNROLLxBLOCKS sizes of the 8-feature walk "
                             "(B1-B6) to build and time beside the source's own")
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()
    walk8_sizes = [tuple(int(v) for v in size.split("x")) for size in args.walk8.split(",")
                   if size]
    if not torch.cuda.is_available():
        print("torch_row_piece_sweep: no CUDA device", file=sys.stderr)
        return 1

    from ultra_tpu_torch import graph as graph_module
    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.graph import build_segments
    from ultra_tpu_torch.ops import build
    from chip_smoke import dw_error, largest_difference, minmax_grad_error
    from ultra_tpu_torch.ops import rspmm_cuda
    from ultra_tpu_torch.ops.rspmm_cuda import (
        rspmm_dw, rspmm_sum_drel, rspmm_sum_drel_plain, rspmm_sum_dx, rspmm_sum_dx_plain,
        rspmm_sum_fwd, rspmm_sum_fwd_plain,
    )
    from ultra_tpu_torch.ops.rspmm_minmax_cuda import (
        rspmm_minmax_drel, rspmm_minmax_drel_terms, rspmm_minmax_dx, rspmm_minmax_dx_terms,
        rspmm_minmax_fwd, rspmm_minmax_fwd_plain,
    )
    from ultra_tpu_torch.utils.benchlib import (
        device_ms, fb15k237_split, uniform_destination_graph,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    record = {"card": card, "device": torch.cuda.get_device_name(0), "sizes": {},
              "segment_sizes": {}, "dw_parts": {}, "bf16": {}, "walk8": {},
              "ptxas": {name: build.ptxas_usage(log)
                        for name, log in build.build_all(SOURCES).items()},
              "sass": {src: sass_counts(build.library_path(src)) for src in WALK8_SOURCES}
              if shutil.which("cuobjdump")
              or Path(build.nvcc_path()).with_name("cuobjdump").exists()
              else "cuobjdump not found"}
    walk8_fns, record["walk8_ptxas"] = build_walk8(walk8_sizes)
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
    for piece in ints(args.pieces):
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
    for parts in ints(args.dw_parts):
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
    for length in ints(args.segment_pieces):
        size = {}
        for tag, on in (("entity", graph), ("relation", graph.relation_graph)):
            seg = build_segments(on.csr, on.num_relations, piece_len=length)
            for name, timed in ((f"rspmm_sum_drel/{tag}/F512", time_drel),
                                (f"rspmm_minmax_drel/{tag}/F512", time_minmax_drel)):
                row = size[name] = timed(on, seg)
                ok &= row["ok"]
                print(f"[sweep] segment piece {length} {name}: {json.dumps(row)}", flush=True)
        record["segment_sizes"][length] = size

    # the bf16 instances on the 8-feature walk at the default pieces, beside
    # the f32 instance on the same values widened; then each --walk8 build
    # of them on the same inputs, the source's own first and last
    rel_graph = graph.relation_graph
    cases = []  # (name, launch(a, b), held(a, b), bf16 rows a, other rows b)

    def sum_case(name, fn, plain, layout, w, a, b):
        cases.append((name, lambda a, b: fn(layout, w, a, b, "mul"),
                      lambda a, b: held(fn, plain, layout, w, a, b, False), a, b))

    for tag, on, feats in (("entity", graph, (512,)), ("relation", rel_graph, (512, 4096))):
        w = masked(on.edge_weight)
        for feat in feats:
            rows16 = lambda n: rand(n, feat).bfloat16()
            sum_case(f"rspmm_sum_fwd[bf16]/{tag}/F{feat}", rspmm_sum_fwd, rspmm_sum_fwd_plain,
                     on.csr, w, rows16(on.num_relations), rows16(on.num_nodes))
        sum_case(f"rspmm_sum_dx[bf16]/{tag}/F512", rspmm_sum_dx, rspmm_sum_dx_plain,
                 on.csr_src, w, rand(on.num_relations, 512).bfloat16(), rand(on.num_nodes, 512))
        sum_case(f"rspmm_sum_drel[bf16]/{tag}/F512", rspmm_sum_drel, rspmm_sum_drel_plain,
                 on.segments, w, rand(on.num_nodes, 512).bfloat16(), rand(on.num_nodes, 512))
    # B3, B4 and B5 (mul, max) at F = 512 and B6 (the sum) at 64 on the
    # entity graph's rows and on the uniform graph's short ones (B4 and B5
    # given B3's output, as time_minmax_dx and time_minmax_drel)
    for tag, on, fwd_csr, out_csr, dx_csr in (
            ("entity", graph, graph.csr, graph.csr, graph.csr_src),
            ("uniform", uniform, uniform.csr, uniform.csr_src, uniform.csr)):
        w = masked(on.edge_weight)
        rel, x = rand(on.num_relations, 512).bfloat16(), rand(on.num_nodes, 512).bfloat16()
        g, out = rand(on.num_nodes, 512), rspmm_minmax_fwd(out_csr, w, rel, x)
        fwd = lambda a, b, csr=fwd_csr, w=w: rspmm_minmax_fwd(csr, w, a, b, "mul")
        dx = lambda a, b, csr=dx_csr, w=w, g=g, out=out: rspmm_minmax_dx(csr, w, a, b, g, out)
        # B5 routes against the forward over the CSR by destination
        out_d = rspmm_minmax_fwd(on.csr, w, rel, x)
        drel = lambda a, b, seg=on.segments, w=w, g=g, out=out_d: rspmm_minmax_drel(
            seg, w, a, b, g, out)
        rel64, x64, g64 = (rand(on.num_relations, 64).bfloat16(),
                           rand(on.num_nodes, 64).bfloat16(), rand(on.num_nodes, 64))
        dw = lambda a, b, csr=on.csr, w=w, g=g64: rspmm_dw(csr, w, a, b, g, "mul")
        cases += [
            (f"rspmm_minmax_fwd[bf16]/{tag}/F512", fwd,
             lambda a, b, fwd=fwd, csr=fwd_csr, w=w: bool(torch.equal(
                 fwd(a, b), rspmm_minmax_fwd_plain(csr, w, a, b, "mul"))), rel, x),
            (f"rspmm_minmax_dx[bf16]/{tag}/F512", dx,
             lambda a, b, dx=dx, csr=dx_csr, w=w, g=g, out=out: minmax_grad_error(
                 dx(a, b), rspmm_minmax_dx_terms, csr, w, a, b, g, out, "mul", b.shape[0])[2],
             rel, x),
            (f"rspmm_minmax_drel[bf16]/{tag}/F512", drel,
             lambda a, b, drel=drel, seg=on.segments, w=w, g=g, out=out_d: minmax_grad_error(
                 drel(a, b), rspmm_minmax_drel_terms, seg, w, a, b, g, out, "mul",
                 a.shape[0])[2], rel, x),
            (f"rspmm_dw[bf16]/{tag}/F64", dw,
             lambda a, b, dw=dw, csr=on.csr, w=w, g=g64: dw_error(
                 dw(a, b), csr, w, a, b, g, "mul", None)[2], rel64, x64)]

    def time_bf16(label):
        rows = {}
        for name, launch, agrees, a, b in cases:
            row = rows[name] = {
                "ok": agrees(a, b),
                "f32_equal": largest_difference(launch(a, b), launch(a.float(), b.float())),
                "ms": device_ms(lambda: launch(a, b))}
            print(f"[sweep] {label} {name}: {json.dumps(row)}", flush=True)
        return rows

    for name, launch, _, a, b in cases:
        a32, b32 = a.float(), b.float()
        record["bf16"][name] = {"f32_ms": device_ms(lambda: launch(a32, b32))}
    for name, row in time_bf16("walk8 source").items():
        record["bf16"][name].update(row, f32_ratio=row["ms"] / record["bf16"][name]["f32_ms"])
        ok &= row["ok"]
    if walk8_fns:
        for size, fns in walk8_fns.items():
            with build.swapped(fns):
                rows = record["walk8"]["x".join(map(str, size))] = time_bf16(f"walk8 {size}")
            ok &= all(row["ok"] for row in rows.values())
        record["walk8"]["source, again"] = time_bf16("walk8 source, again")

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
