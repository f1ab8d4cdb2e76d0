"""How E2 (``csrc/conv_tail.cu``, the conv's tail) should tile its rows:
time it on the card at the shapes of the benchmark's cells and of the paths
that share it, with the source's sizes and with variants built again under
``build/conv_tail_sweep/``, beside the three ops it replaced.

  python3 scripts/torch_conv_tail_sweep.py [--variants 128x4x2,64x4x3+unroll4,noload]
      [--out build/conv_tail_sweep.json]

A variant ``BMxTRxS`` sets the tile's sizes (``CONV_TAIL_SIZES``: rows a
tile, rows a thread, stages), ``unrollN`` unrolls the product's loop over k N
times, and the probes ``noload`` and ``nomath`` leave out the loads of x and
u or the products (their outputs are not held); several are joined by
``+``. The shapes (rows of 64, ReLU and the short cut): ``rank`` the
ranking cell's entity pass (123,182 nodes x 16 queries), ``eval`` the
evaluation cell's (14,505 x 32), ``serve`` a batch of 8 on FB15k-237 (14,541
x 8), ``precompute`` the relation model's at 474 relations (FB15k-237's and
the evaluation cell's, x 64 queries) and ``rank-precompute`` at the ranking
cell's 74.

For each it prints the median device ms (``benchlib.device_ms``) of the
source's build, of each variant, and of the ops E2 replaced (``torch.cat``,
``F.linear`` and E1, together as ``library_ms`` and each alone), the bound
(x and u read and the output written once against 2 * 128 * 64 f32
operations a row), and each build's max |err| against the plain twin over
the output's largest |value|. Needs one CUDA card; prints the card's name
and power limit, one line a timing, then the record as JSON, which ``--out``
also writes. Exits 1 if a build's error passes 1e-5 of the output's scale.
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
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
SHAPES = (("rank", 123_182 * 16), ("eval", 14_505 * 32), ("serve", 14_541 * 8),
          ("precompute", 474 * 64), ("rank-precompute", 74 * 64))
REL_TOL = 1e-5  # tests/test_torch_conv_tail.py


# timing probes, whose outputs are not held: without the loads of x and u,
# and without the products
PROBES = {"noload": "    cp_async16(stage + part * BM * kRow + r * kRow + q * 4, src, live);\n",
          "nomath": "    multiply<BM, TR>(acc, xs, wt, group, col);\n"
                    "    multiply<BM, TR>(acc, xs + BM * kRow, wt + kN * kN, group, col);\n"}
UNROLL = re.compile(r"#pragma unroll \d+\n  for \(int k0 = 0;")


def edit_variant(name: str, source: str) -> str:
    """``csrc/conv_tail.cu`` as text with variant ``name`` applied (several
    joined by ``+``): ``BMxTRxS`` the sizes, ``unrollN`` the product's loop
    over k unrolled N times, or a probe of :data:`PROBES`."""
    for part in name.split("+"):
        if part in PROBES:
            old, new = PROBES[part], ""
        elif re.fullmatch(r"unroll\d+", part):
            old = UNROLL.search(source).group(0)
            new = re.sub(r"\d+", part.removeprefix("unroll"), old, count=1)
        elif re.fullmatch(r"\d+x\d+x\d+", part):
            old = re.search(r"#define CONV_TAIL_SIZES .*", source).group(0)
            new = f"#define CONV_TAIL_SIZES {', '.join(part.split('x'))}"
        else:
            raise ValueError(f"unknown variant {part!r}")
        if source.count(old) != 1:
            raise RuntimeError(f"variant {part}: its pattern is not once in csrc/conv_tail.cu")
        source = source.replace(old, new)
    return source


def build_variants(names):
    """E2 built under build/conv_tail_sweep/<name>/ for the source as it is
    and each variant: ({name: bound C function}, {name: the compiler's
    resource lines})."""
    from ultra_tpu_torch.ops import build

    source = (ROOT / "ultra_tpu_torch" / "csrc" / "conv_tail.cu").read_text()
    procs = {}
    for name in ("source", *names):
        d = ROOT / "build" / "conv_tail_sweep" / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        text = source if name == "source" else edit_variant(name, source)
        (d / "conv_tail.cu").write_text(text)
        procs[name] = (d / "libconv_tail.so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "libconv_tail.so"),
             str(d / "conv_tail.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns, usage = {}, {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        usage[name] = build.ptxas_usage(log)
        fns[name] = build.bind("conv_tail", ctypes.CDLL(str(lib)))
    return fns, usage


def operands(rows, gen):
    """x, u (rows, 64), the linear's weight and bias, gamma and beta, on the
    card."""
    x = torch.randn(rows, 64, generator=gen, device="cuda")
    u = 4 * torch.randn(rows, 64, generator=gen, device="cuda") + 0.5
    w = (torch.rand(64, 128, generator=gen, device="cuda") - 0.5) / 4
    b = torch.randn(64, generator=gen, device="cuda") / 4
    gamma = torch.rand(64, generator=gen, device="cuda") + 0.5
    beta = torch.randn(64, generator=gen, device="cuda")
    return x, u, w, b, gamma, beta


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default="",
                        help="comma-separated builds of E2 to time beside the source's")
    parser.add_argument("--out", help="also write the record to this JSON file")
    args = parser.parse_args()
    variants = [v for v in args.variants.split(",") if v]
    if not torch.cuda.is_available():
        print("torch_conv_tail_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    from ultra_tpu_torch.ops import build
    from ultra_tpu_torch.ops.conv_tail_cuda import conv_tail, conv_tail_plain
    from ultra_tpu_torch.ops.epilogue_cuda import conv_epilogue
    from ultra_tpu_torch.utils.benchlib import bound_ms, device_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    record = {"card": card, "device": torch.cuda.get_device_name(0), "cases": {}}
    variant_fns, record["ptxas"] = build_variants(variants)
    del variant_fns["source"]  # timed as the package builds it
    for name, usage in record["ptxas"].items():
        print(f"[ptxas] {name}: {usage}", flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    ok = True
    for label, rows in SHAPES:
        x, u, w, b, gamma, beta = operands(rows, gen)
        args_ = (x, u, w, b, gamma, beta, 1e-5, True, x)
        want = conv_tail_plain(*args_)
        scale = float(want.abs().max())

        def tail():
            return conv_tail(*args_)

        def rel_err():
            return float((tail() - want).abs().max()) / scale

        cat = torch.cat([x, u], dim=-1)
        y = F.linear(cat, w, b)
        least, by = bound_ms(3 * 4 * rows * 64, 2 * 128 * 64 * rows)
        row = {"rows": rows, "bound_ms": least, "bound_by": by,
               "library_ms": device_ms(lambda: conv_epilogue(
                   F.linear(torch.cat([x, u], dim=-1), w, b), gamma, beta, 1e-5, True, x)),
               "cat_ms": device_ms(lambda: torch.cat([x, u], dim=-1)),
               "linear_ms": device_ms(lambda: F.linear(cat, w, b)),
               "e1_ms": device_ms(lambda: conv_epilogue(y, gamma, beta, 1e-5, True, x)),
               "err": {"source": rel_err()}, "ms": {"source": device_ms(tail)}}
        del cat, y
        for name, fn in variant_fns.items():
            with build.swapped({"conv_tail": fn}):
                row["err"][name] = rel_err()
                row["ms"][name] = device_ms(tail)
        ok &= all(e <= REL_TOL for name, e in row["err"].items()
                  if not set(name.split("+")) & set(PROBES))
        for name in row["ms"]:
            print(f"[conv_tail] {label} ({rows}, 64) {name}: {row['ms'][name]:.4f} ms "
                  f"(bound {least:.4f}, {by}; {100 * least / row['ms'][name]:.1f}%), "
                  f"err {row['err'][name]:.3g}", flush=True)
        print(f"[conv_tail] {label}: cat + linear + E1 {row['library_ms']:.4f} ms (cat "
              f"{row['cat_ms']:.4f}, linear {row['linear_ms']:.4f}, E1 {row['e1_ms']:.4f})",
              flush=True)
        record["cases"][label] = row
        del x, u, want, args_
        torch.cuda.empty_cache()

    print(json.dumps(record, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if not ok:
        print(f"torch_conv_tail_sweep: a build's error passes {REL_TOL} of the output's scale",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
