"""On-card smoke run of the PyTorch/CUDA port (``ultra_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, on one H100

It needs one CUDA card and exits non-zero without one. In order, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``ultra_tpu_torch/csrc`` with
   ``nvcc``, one process per source, all started together;
3. turns TF32 off for matrix products and convolutions;
4. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving, training and validation paths give it, and times
   both with CUDA events: the sum forward B1 (entity graph F=512 and
   F=1024, relation graph F=512 and F=4096), B1 on the source-major CSR for
   the input gradient and B2 for the relation gradient (both graphs, F=512;
   B2 timed for ``mul`` and ``add``), for ``mul`` and ``add`` with 10% of
   the weights zeroed; and the min/max kernels B3 (forward), B4 (input
   gradient) and B5 (relation gradient) on both graphs at F=512, for each
   ``mul`` and each of min and max, on tie-heavy inputs and on normal ones;
5. serves zero-shot link prediction at the full ``ultra_3g`` width (6x64
   RelNBFNet + 6x64 EntityNBFNet, distmult, sum) with random weights from a
   seed, on the FB15k-237-shaped synthetic graph, through
   ``UltraPredictor.from_checkpoint``: the precompute and a few batches of
   tail and head requests, with the kernels' launch counters read around
   each phase; its scores are compared with the same predictor on the CPU;
6. fine-tunes the same model on the same graph: batch 8, 256 strict
   negatives, easy-edge masks, AdamW. One step's loss and gradients are
   compared with the same step on the CPU (and, as a control of that check,
   the same step with TF32 matrix products; and, to show how far rounding
   alone moves them, the same step from weights moved by one unit in the
   last place); a few warm steps and then timed
   ones give step time, steps/s and peak memory, with the launches of each
   kernel on each graph per step asserted; then ``train_and_validate`` runs
   a short epoch with filtered validation and a checkpoint, its launches
   read around it, and a timed filtered validation of the trained model;
7. serves (``[pna-serving]``) and fine-tunes (``[pna-training]``) the PNA
   configuration the same way: the entity model aggregates with PNA (sum,
   sum of squares, max and min per layer: B1 and B3, and in training B4
   and B5), the relation model with sum. Its step's gradients are held to a
   bound on the median over the tensors (see MINMAX_GRAD_MEDIAN);
8. holds a ``max`` conv and a ``rotate`` conv (its sum runs B1 at twice the
   width) on the card against the same conv on the CPU;
9. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line.

Any failed check raises before the last line is printed.
``--phases`` runs a subset (for example ``--phases kernels`` to build and
check the kernels alone); the last line is then not printed.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

BATCH = 8  # config/transductive/inference.yaml train.batch_size
TOPK = 10
TAIL_BATCHES, HEAD_BATCHES, TIMED_BATCHES = 3, 1, 20
TIMED_PRECOMPUTES = 5
PRECOMPUTE_CHUNK = 64  # train/eval.py precompute_relation_representations
# the sources in ultra_tpu_torch/csrc
KERNELS = ("rspmm_sum_fwd", "rspmm_sum_drel", "rspmm_minmax_fwd", "rspmm_minmax_dx",
           "rspmm_minmax_drel")
# the kernel wrappers, each with its launch counter
WRAPPERS = ("rspmm_sum_fwd", "rspmm_sum_dx", "rspmm_sum_drel", "rspmm_minmax_fwd",
            "rspmm_minmax_dx", "rspmm_minmax_drel")
PHASES = ("kernels", "serving", "training", "pna-serving", "pna-training", "conv")
# the PNA configuration (benchlib.pna_config): ultra_3g widths, a sum
# relation model and a PNA entity model, whose layers' linear takes 13 * 64
PNA_PARAMS = 439041

# fine-tuning as config/transductive/inference.yaml: batch 8, 256 strict
# negatives, adversarial temperature 1, AdamW lr 5e-4, weight decay 0.01
NUM_NEGATIVE, LR, WEIGHT_DECAY = 256, 5e-4, 0.01
WARM_STEPS, TIMED_STEPS = 3, 10
# train_and_validate: one short epoch, then a filtered validation of 64
# triples (8 batches), enough for collect_rankings to take its cached branch
# on this graph (8 batches > 474 relations / 64), as a full validation does
RUNNER_STEPS, RUNNER_VALID = 4, 64

# Kernel vs plain on the card: the kernel sums in f32; the plain version
# runs on the same inputs in f64, so the difference is the kernel's own
# rounding. The rounding of a sum is bounded by a multiple of
# eps(f32) = 1.19e-7 times the sum of the absolute values of its terms, so
# the bound per element is 1e-5 (84 eps) times that sum, plus 1e-6. (An f32
# plain version would add its own rounding: index_add_ adds a type's up to
# 23,200 terms one by one into one f32 value.)
KERNEL_REL_TO_ABS_SUM, KERNEL_ATOL = 1e-5, 1e-6
# Served scores, card vs CPU: 12 layers of f32 with cuBLAS and the CPU's
# matrix products and sums in different orders.
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-4
# One train step, card vs CPU, from the same weights and batch: the loss to
# rtol 1e-5; each parameter's gradient to 1e-4 of that tensor's largest
# entry plus 1e-7. The gradient runs back through 12 layers whose sums are
# taken in other orders on the two sides, and an entry near 0 has no
# relative precision of its own, so the bound scales with the tensor. The
# worst reading on an H100 was 1.23e-5 (PERF.md), 8x inside the bound; the
# same step with TF32 matrix products (rounding about 5e-4) is run as a
# control and must fall outside it (it read 0.031 there).
LOSS_RTOL, GRAD_REL_TO_MAX, GRAD_ATOL = 1e-5, 1e-4, 1e-7
# A step of a model with a max or a PNA aggregator has no such bound. Its
# gradient goes to every edge that ties for the extreme, the whole of it to
# each, so where a group of equal messages (from sources whose states are
# equal) and another message nearly tie, rounding decides whether the
# gradient goes to one edge or to each of the group: the gradient jumps.
# On an H100 (PERF.md) the PNA step read 0.037 of a tensor's largest
# entry at worst against the CPU, and the same step on the card from
# weights moved by one unit in the last place read 0.162 against the
# unmoved one: rounding alone sets the worst reading. The median over the
# tensors stays small (5.1e-4 against the CPU, 2.0e-4 for the moved
# weights) and TF32 moves it (0.027), so the bound is on the median over
# the tensors, with a loose bound on the worst tensor against gross faults.
MINMAX_GRAD_MEDIAN, MINMAX_GRAD_WORST = 5e-3, 0.5
# B3 against its plain version in f32: equal, value for value (a min or a
# max is exact, and both compute each message with the same two roundings);
# B4 and B5 against plain versions that route in f32 exactly as the forward
# did and add in f64, within KERNEL_REL_TO_ABS_SUM * sum|terms| + KERNEL_ATOL.


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the larger of the bytes over the card's
    memory rate and the f32 operations over its peak f32 rate."""
    from ultra_tpu_torch.utils.benchlib import H100_BYTES_PER_S, H100_F32_FLOPS

    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _live(edge_weight, eid):
    return int((edge_weight[eid.long()] != 0).sum())


def rspmm_bound_ms(csr, edge_weight, relation, x, mul="mul"):
    """Least time for one sum (or min/max) rspmm on these inputs: each input
    read once (x, relation, the CSR and the weight of each CSR edge), the
    output written once, and 3 f32 operations per feature of each edge whose
    weight is not 0. Returns (ms, "bytes" | "operations")."""
    num_rows, feat = csr.rowptr.numel() - 1, x.shape[1]
    nbytes = 4 * (x.numel() + relation.numel() + num_rows * feat)
    nbytes += 8 * (num_rows + 1) + (4 + 4 + 4 + 4) * csr.col.numel()
    return _bound(nbytes, 3 * _live(edge_weight, csr.eid) * feat)


def drel_bound_ms(seg, edge_weight, x, g, mul="mul"):
    """Least time for one sum relation gradient on these inputs: x (mul
    only), g and the segments (src, dst, eid and the weight of each edge,
    the chunk tables) read once, d_rel written once, and 3 (mul) or 2 (add)
    f32 operations per feature of each edge whose weight is not 0."""
    feat, num_edges = g.shape[1], seg.src.numel()
    nbytes = 4 * ((x.numel() if mul == "mul" else 0) + g.numel() + seg.num_types * feat)
    nbytes += 16 * num_edges + 8 * (seg.chunkptr.numel() + seg.type_chunkptr.numel())
    return _bound(nbytes, (3 if mul == "mul" else 2) * _live(edge_weight, seg.eid) * feat)


def minmax_dx_bound_ms(csr_src, edge_weight, relation, x, g):
    """Least time for one min/max input gradient on these inputs: x, g, the
    saved output (g's shape), the relation rows and the CSR read once, d_x
    written once, and 6 f32 operations per feature of each edge whose weight
    is not 0 (the message, its compare, the routed product and the sum)."""
    nbytes = 4 * (2 * x.numel() + 2 * g.numel() + relation.numel())
    nbytes += 8 * csr_src.rowptr.numel() + 16 * csr_src.col.numel()
    return _bound(nbytes, 6 * _live(edge_weight, csr_src.eid) * x.shape[1])


def minmax_drel_bound_ms(seg, edge_weight, relation, x, g):
    """Least time for one min/max relation gradient on these inputs: x, g,
    the saved output, the relation rows, the segments and the chunk tables
    read once, the partial rows written and read once, d_rel written once,
    and 6 f32 operations per feature of each edge whose weight is not 0."""
    feat = g.shape[1]
    nbytes = 4 * (x.numel() + 2 * g.numel() + 2 * relation.numel())
    nbytes += 4 * 2 * (seg.chunkptr.numel() - 1) * feat
    nbytes += 16 * seg.src.numel() + 8 * (seg.chunkptr.numel() + seg.type_chunkptr.numel())
    return _bound(nbytes, 6 * _live(edge_weight, seg.eid) * feat)


def kernel_row(name, source, replaces, out_shape, ms, plain_ms, bound, max_abs_err,
               tolerance, on_path=True, **extra):
    """One entry of the kernels line; ``launches`` is filled in at the end
    from the main path's counts at ``out_shape``."""
    bound_ms, bound_by = bound
    print(f"[kernel] {name}: ms={ms!r} plain_ms={plain_ms!r} bound_ms={bound_ms!r} "
          f"({bound_by})", flush=True)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this function
            "out_shape": list(out_shape), "on_path": on_path, "tolerance": tolerance,
            **extra}


def hold(name, source, timed, kernel, plain, layout, weight, a, b, bound):
    """``kernel(layout, weight, a, b, mul)`` against ``plain`` on the same
    inputs in f64, for mul and add, within KERNEL_REL_TO_ABS_SUM of the sum
    of the absolute terms (``plain`` on absolute inputs) plus KERNEL_ATOL;
    times both (``plain`` in f32, as the path would run it) for each ``mul``
    of ``timed``, which maps it to the TPU kernel it replaces. Returns (rows
    of the kernels line, ok); the row of "add" is named ``name`` with
    ``_add`` after the wrapper's name and is not on the path (distmult)."""
    from ultra_tpu_torch.utils.benchlib import device_ms

    w64, a64, b64 = weight.double(), a.double(), b.double()
    errs, ok = {}, True
    for mul in ("mul", "add"):
        got = kernel(layout, weight, a, b, mul)
        want = plain(layout, w64, a64, b64, mul)
        abs_sum = plain(layout, w64.abs(), a64.abs(), b64.abs(), mul)
        torch.cuda.synchronize()
        err = (got.double() - want).abs()
        within = err / (KERNEL_REL_TO_ABS_SUM * abs_sum + KERNEL_ATOL)
        case_ok = bool(torch.isfinite(got).all()) and got.shape == want.shape
        case_ok &= bool((within <= 1).all())
        ok &= case_ok
        rel = float(err.max() / want.abs().max().clamp_min(1e-30))
        errs[mul] = float(err.max())
        print(f"[kernel] {name} mul={mul} {tuple(got.shape)}: ok={case_ok} "
              f"max_abs_err={float(err.max())!r} max_rel_err={rel!r} "
              f"worst_err_over_tolerance={float(within.max())!r}", flush=True)

    rows = []
    for mul, replaces in timed.items():
        wrapper, rest = name.split("/", 1)
        row_name = name if mul == "mul" else f"{wrapper}_{mul}/{rest}"
        rows.append(kernel_row(
            row_name, source, replaces, got.shape,
            device_ms(lambda: kernel(layout, weight, a, b, mul)),
            device_ms(lambda: plain(layout, weight, a, b, mul)),
            bound(layout, weight, a, b, mul), errs[mul],
            f"|err| <= {KERNEL_REL_TO_ABS_SUM} * sum|terms| + {KERNEL_ATOL} against the "
            "plain version in f64", on_path=mul == "mul", mul=mul,
        ))
    return rows, ok


def minmax_weights(g_, gen):
    """The graph's weights times 0.5, 1 or 2 (exact products), 10% of them
    0, and every edge into one row 0: (weights on the card, that row)."""
    w = g_.edge_weight.cpu()
    w = w * torch.tensor([0.5, 1.0, 2.0])[torch.randint(0, 3, w.shape, generator=gen)]
    w[torch.rand(w.shape, generator=gen) < 0.1] = 0.0
    rowptr = g_.csr.rowptr.cpu()
    row = int(torch.nonzero(rowptr.diff() >= 2)[0])
    w[g_.csr.eid[rowptr[row]:rowptr[row + 1]].cpu().long()] = 0.0
    return w.cuda(), row


def hold_minmax(tag, g_, feat, gen, replaces):
    """B3, B4 and B5 against their plain versions on ``g_`` at ``feat``, on
    tie-heavy inputs (relation and x from {-3..3}, a quarter of x's rows 0)
    and on normal ones, for mul and add and for max and min, with weights
    from ``minmax_weights``. B3 must equal its f32 plain version value for
    value, the all-masked row's -inf/+inf included; B4 and B5, given B3's
    output, must match plain versions that route in f32 as the forward did
    and add in f64. Times the three (normal inputs, mul, max) beside their
    plain versions in f32. Returns ({row name: row}, ok)."""
    from ultra_tpu_torch.ops import rspmm_minmax_cuda as k
    from ultra_tpu_torch.utils.benchlib import device_ms

    w, masked_row = minmax_weights(g_, gen)
    n, r = g_.num_nodes, g_.num_relations
    ties_x = torch.randint(-3, 4, (n, feat), generator=gen).float()
    ties_x[torch.rand(n, generator=gen) < 0.25] = 0.0
    inputs = {
        "ties": (torch.randint(-3, 4, (r, feat), generator=gen).float().cuda(), ties_x.cuda()),
        "normal": (torch.randn(r, feat, generator=gen).cuda(),
                   torch.randn(n, feat, generator=gen).cuda()),
    }
    g = torch.randn(n, feat, generator=gen).cuda()
    grads = (("dx", k.rspmm_minmax_dx, k.rspmm_minmax_dx_terms, g_.csr_src, n),
             ("drel", k.rspmm_minmax_drel, k.rspmm_minmax_drel_terms, g_.segments, r))
    ok, errs = True, {"fwd": 0.0, "dx": 0.0, "drel": 0.0}
    for kind, (rel, x) in inputs.items():
        for mul in ("mul", "add"):
            for is_min in (False, True):
                case = f"{tag} {kind} mul={mul} {'min' if is_min else 'max'}"
                out = k.rspmm_minmax_fwd(g_.csr, w, rel, x, mul, is_min)
                want = k.rspmm_minmax_fwd_plain(g_.csr, w, rel, x, mul, is_min)
                torch.cuda.synchronize()
                differ = int((out != want).sum())
                fwd_ok = differ == 0 and bool(torch.isinf(out[masked_row]).all())
                finite = torch.isfinite(want)
                errs["fwd"] = max(errs["fwd"], float((out - want)[finite].abs().max()))
                ok &= fwd_ok
                print(f"[kernel] rspmm_minmax_fwd {case}: ok={fwd_ok} differing={differ} "
                      f"inf_rows={int((~finite).all(1).sum())}", flush=True)
                for grad, kernel, terms_fn, layout, rows in grads:
                    got = kernel(layout, w, rel, x, g, out, mul)
                    index, terms = terms_fn(layout, w, rel, x, g.double(), out, mul)
                    routed = int((terms != 0).sum())
                    want = torch.zeros(rows, feat, dtype=torch.float64, device="cuda")
                    abs_sum = torch.zeros_like(want).index_add_(0, index, terms.abs())
                    want.index_add_(0, index, terms)
                    del index, terms
                    torch.cuda.synchronize()
                    err = (got.double() - want).abs()
                    within = float((err / (KERNEL_REL_TO_ABS_SUM * abs_sum + KERNEL_ATOL)).max())
                    case_ok = bool(torch.isfinite(got).all()) and within <= 1
                    ok &= case_ok
                    errs[grad] = max(errs[grad], float(err.max()))
                    print(f"[kernel] rspmm_minmax_{grad} {case}: ok={case_ok} "
                          f"max_abs_err={float(err.max())!r} worst_err_over_tolerance="
                          f"{within!r} routed_terms={routed}", flush=True)
    rel, x = inputs["normal"]
    out = k.rspmm_minmax_fwd(g_.csr, w, rel, x, "mul", False)
    grad_tol = (f"|err| <= {KERNEL_REL_TO_ABS_SUM} * sum|terms| + {KERNEL_ATOL} against the "
                "plain version routed in f32 and added in f64")
    rows = [
        kernel_row(
            f"rspmm_minmax_fwd/{tag}/F{feat}", "ultra_tpu_torch/csrc/rspmm_minmax_fwd.cu",
            replaces["fwd"], out.shape,
            device_ms(lambda: k.rspmm_minmax_fwd(g_.csr, w, rel, x, "mul", False)),
            device_ms(lambda: k.rspmm_minmax_fwd_plain(g_.csr, w, rel, x, "mul", False)),
            rspmm_bound_ms(g_.csr, w, rel, x), errs["fwd"],
            "equal to the plain version in f32, value for value", on_path=tag == "entity"),
        kernel_row(
            f"rspmm_minmax_dx/{tag}/F{feat}", "ultra_tpu_torch/csrc/rspmm_minmax_dx.cu",
            replaces["dx"], x.shape,
            device_ms(lambda: k.rspmm_minmax_dx(g_.csr_src, w, rel, x, g, out, "mul")),
            device_ms(lambda: k.rspmm_minmax_dx_plain(g_.csr_src, w, rel, x, g, out, "mul")),
            minmax_dx_bound_ms(g_.csr_src, w, rel, x, g), errs["dx"], grad_tol,
            on_path=tag == "entity"),
        kernel_row(
            f"rspmm_minmax_drel/{tag}/F{feat}", "ultra_tpu_torch/csrc/rspmm_minmax_drel.cu",
            replaces["drel"], rel.shape,
            device_ms(lambda: k.rspmm_minmax_drel(g_.segments, w, rel, x, g, out, "mul")),
            device_ms(lambda: k.rspmm_minmax_drel_plain(g_.segments, w, rel, x, g, out, "mul")),
            minmax_drel_bound_ms(g_.segments, w, rel, x, g), errs["drel"], grad_tol,
            on_path=tag == "entity"),
    ]
    return {row["name"]: row for row in rows}, ok


def check_kernels(graph, num_rel, cfg, gen):
    """Every kernel wrapper against its plain version at each shape the
    serving, training and validation paths give it: F = 512 (a batch of 8,
    D = 64) for training and serving, 1024 for validation's two directions
    on the entity graph, 4096 for the precompute's 64 relations on the
    relation graph. Returns ({row name: row}, ok); a row's ``out_shape`` is
    the launch-count key of its launches."""
    from ultra_tpu_torch.ops import rspmm_cuda as k

    fwd_src, drel_src = (f"ultra_tpu_torch/csrc/{n}.cu" for n in KERNELS[:2])
    dim = cfg.entity_model.input_dim
    train_feat = BATCH * dim
    rows, ok = {}, True
    # the TPU kernels each launch site replaces: on the TPU the input gradient
    # is the forward kernel on the source plan (rspmm_pallas.py:1341-1374)
    # and the relation gradient the v2 or the v1 kernel (:1375-1392); the
    # min/max gradients run the v2 kernels with v2 plans, else the v1 ones
    # (rspmm_pallas.py:852-963)
    for tag, g_, rel_rows, fwd_feats, fwd_replaces, drel_replaces, minmax_replaces in (
        ("entity", graph, num_rel, (train_feat, 2 * train_feat),
         "ultra_tpu/ops/rspmm_pallas_v2.py:508", "ultra_tpu/ops/rspmm_pallas_v2.py:1054",
         {"fwd": "ultra_tpu/ops/rspmm_pallas_v2.py:704",
          "dx": "ultra_tpu/ops/rspmm_pallas_v2.py:927",
          "drel": "ultra_tpu/ops/rspmm_pallas_v2.py:982"}),
        ("relation", graph.relation_graph, graph.relation_graph.num_relations,
         (train_feat, PRECOMPUTE_CHUNK * dim), "ultra_tpu/ops/rspmm_pallas.py:283",
         "ultra_tpu/ops/rspmm_pallas.py:381",
         {"fwd": "ultra_tpu/ops/rspmm_pallas.py:574",
          "dx": "ultra_tpu/ops/rspmm_pallas.py:704",
          "drel": "ultra_tpu/ops/rspmm_pallas.py:745"}),
    ):
        keep = torch.rand(g_.edge_weight.shape, generator=gen) >= 0.1
        w = (g_.edge_weight.cpu() * keep).cuda()
        rand = lambda *shape: torch.randn(*shape, generator=gen).cuda()
        # B2 for add is _drel_add_kernel's function, off the path (distmult)
        # and timed for its row on the entity graph
        drel_timed = {"mul": drel_replaces}
        if tag == "entity":
            drel_timed["add"] = "ultra_tpu/ops/rspmm_pallas_v2.py:1022"
        cases = [
            (f"rspmm_sum_fwd/{tag}/F{feat}", fwd_src, {"mul": fwd_replaces}, k.rspmm_sum_fwd,
             k.rspmm_sum_fwd_plain, g_.csr, rand(rel_rows, feat),
             rand(g_.num_nodes, feat), rspmm_bound_ms)
            for feat in fwd_feats
        ] + [
            (f"rspmm_sum_dx/{tag}/F{train_feat}", fwd_src, {"mul": fwd_replaces},
             k.rspmm_sum_dx, k.rspmm_sum_dx_plain, g_.csr_src, rand(rel_rows, train_feat),
             rand(g_.num_nodes, train_feat), rspmm_bound_ms),
            (f"rspmm_sum_drel/{tag}/F{train_feat}", drel_src, drel_timed,
             k.rspmm_sum_drel, k.rspmm_sum_drel_plain, g_.segments,
             rand(g_.num_nodes, train_feat), rand(g_.num_nodes, train_feat), drel_bound_ms),
        ]
        for name, source, timed, kernel, plain, layout, a, b, bound in cases:
            case_rows, case_ok = hold(name, source, timed, kernel, plain, layout, w, a, b,
                                      bound)
            rows.update((row["name"], row) for row in case_rows)
            ok &= case_ok
        minmax_rows, minmax_ok = hold_minmax(tag, g_, train_feat, gen, minmax_replaces)
        rows.update(minmax_rows)
        ok &= minmax_ok
        torch.cuda.empty_cache()
    return rows, ok


def serve(split, ckpt, device):
    from ultra_tpu_torch.serve import UltraPredictor

    return UltraPredictor.from_checkpoint(str(ckpt), split, device=device,
                                          batch_size=BATCH)


def wrappers():
    from ultra_tpu_torch.ops import rspmm_cuda, rspmm_minmax_cuda

    return [getattr(rspmm_cuda if name.startswith("rspmm_sum") else rspmm_minmax_cuda, name)
            for name in WRAPPERS]


def launch_counts():
    """{wrapper: {output shape (rows, F): launches}} since the last reset."""
    return {f.__name__: dict(f.launches) for f in wrappers()}


def reset_launch_counts():
    for f in wrappers():
        f.launches.clear()


def fwd_launches(counts):
    return sum(counts["rspmm_sum_fwd"].values())


def as_json(counts):
    return {name: {f"{r}x{f}": n for (r, f), n in sorted(by_shape.items())}
            for name, by_shape in counts.items()}


def times(counts, n):
    return {name: {shape: n * c for shape, c in by_shape.items()}
            for name, by_shape in counts.items()}


def plus(a, b):
    out = {name: dict(by_shape) for name, by_shape in a.items()}
    for name, by_shape in b.items():
        for shape, c in by_shape.items():
            out[name][shape] = out[name].get(shape, 0) + c
    return out


def add_launches(counts, name, shape, n):
    if n:
        counts[name][shape] = counts[name].get(shape, 0) + n


def rspmm_calls_per_layer(aggregate):
    """(sum rspmm, min/max rspmm) calls of one conv layer: PNA takes a sum,
    a sum of squares, a max and a min."""
    return {"sum": (1, 0), "mean": (1, 0), "max": (0, 1), "pna": (2, 2)}[aggregate]


def forward_launches(model_cfg, num_rows, feat):
    """Forward launches of one pass of an NBFNet on a graph of ``num_rows``
    nodes, by wrapper and output shape."""
    counts = {name: {} for name in WRAPPERS}
    n_sum, n_ext = rspmm_calls_per_layer(model_cfg.aggregate_func)
    layers = len(model_cfg.hidden_dims)
    add_launches(counts, "rspmm_sum_fwd", (num_rows, feat), n_sum * layers)
    add_launches(counts, "rspmm_minmax_fwd", (num_rows, feat), n_ext * layers)
    return counts


def per_step_launches(cfg, num_nodes, num_rel):
    """What autograd asks of the rspmm in one step, by output shape: a
    forward, a relation gradient and an input gradient of each rspmm call of
    every layer of both models, except the input gradients of the relation
    model's first layer, whose input is a constant boundary. The relation
    graph has ``num_rel`` nodes and 4 edge types; the entity graph
    ``num_nodes`` nodes and ``num_rel`` edge types."""
    feat = BATCH * cfg.entity_model.input_dim
    counts = plus(forward_launches(cfg.relation_model, num_rel, feat),
                  forward_launches(cfg.entity_model, num_nodes, feat))
    for model, rows, types, dx_layers in (
        (cfg.relation_model, num_rel, 4, len(cfg.relation_model.hidden_dims) - 1),
        (cfg.entity_model, num_nodes, num_rel, len(cfg.entity_model.hidden_dims)),
    ):
        n_sum, n_ext = rspmm_calls_per_layer(model.aggregate_func)
        layers = len(model.hidden_dims)
        add_launches(counts, "rspmm_sum_dx", (rows, feat), n_sum * dx_layers)
        add_launches(counts, "rspmm_sum_drel", (types, feat), n_sum * layers)
        add_launches(counts, "rspmm_minmax_dx", (rows, feat), n_ext * dx_layers)
        add_launches(counts, "rspmm_minmax_drel", (types, feat), n_ext * layers)
    return counts


def validation_launches(cfg, num_nodes, num_rel, num_triples):
    """Forward launches of a filtered validation of ``num_triples`` triples
    (train/eval.py::collect_rankings), by wrapper and output shape. With few
    batches, each direction of each batch runs both models; with many, the
    relation model runs once per chunk of 64 relations and both directions
    share one entity-model pass per batch."""
    dim = cfg.entity_model.input_dim
    batches = -(-num_triples // BATCH)
    if num_triples / BATCH > num_rel / PRECOMPUTE_CHUNK:
        rel = forward_launches(cfg.relation_model, num_rel, PRECOMPUTE_CHUNK * dim)
        return plus(times(rel, -(-num_rel // PRECOMPUTE_CHUNK)),
                    times(forward_launches(cfg.entity_model, num_nodes, 2 * BATCH * dim),
                          batches))
    return times(plus(forward_launches(cfg.relation_model, num_rel, BATCH * dim),
                      forward_launches(cfg.entity_model, num_nodes, BATCH * dim)),
                 2 * batches)


def train_steps(split, graph, cfg, tag="training"):
    """One step held against the same step on the CPU, the same step with
    TF32 matrix products as a control of that comparison, the same step on
    the card from weights moved by one unit in the last place (how far
    rounding alone moves the gradients), then WARM_STEPS warm and
    TIMED_STEPS timed steps on the card, each with its own sampled batch
    and easy-edge mask. Prints the ``[tag]`` record, then checks. Returns
    (whether the TF32 control passed the gradient check, the timed steps'
    launches)."""
    from ultra_tpu_torch import tasks
    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params, make_train_step
    from ultra_tpu_torch.train.runner import triples_of

    index = tasks.GraphIndex.build(split.edge_index, split.edge_type, split.num_nodes,
                                   split.num_relations)
    triples = triples_of(split)
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    batches = []
    for _ in range(1 + WARM_STEPS + TIMED_STEPS):
        pos = triples[rng.choice(len(triples), BATCH, replace=False)]
        batch = tasks.negative_sampling(index, pos, NUM_NEGATIVE, strict=True, rng=rng)
        batches.append((batch, tasks.easy_edge_weights(index, batch, graph.num_edges_padded)))
    sample_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    masked = [int((ew[: split.edge_index.shape[1]] == 0).sum()) for _, ew in batches]
    on_card = [tuple(torch.as_tensor(a, device="cuda") for a in b) for b in batches]

    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    state = init_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY)
    step = make_train_step(adversarial_temperature=1.0, num_negative=NUM_NEGATIVE)

    reset_launch_counts()
    losses = [step(state, graph, *on_card[0])]
    torch.cuda.synchronize()
    first_counts = launch_counts()
    grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}

    # the same step on the CPU, from the same weights, batch and mask
    t0 = time.perf_counter()
    cpu_model = Ultra(cfg)
    cpu_model.load_state_dict(init)
    cpu_state = init_train_state(cpu_model, lr=LR, weight_decay=WEIGHT_DECAY)
    cpu_loss = float(step(cpu_state, split_to_graph(split, device="cpu"),
                          *(torch.as_tensor(a) for a in batches[0])))
    cpu_step_s = time.perf_counter() - t0
    cpu_grads = {k: p.grad for k, p in cpu_state.model.named_parameters()}

    minmax = any(m.aggregate_func in ("max", "pna")
                 for m in (cfg.relation_model, cfg.entity_model))

    def grad_errors(card_grads, reference=cpu_grads):
        """({tensor: max|err| / max|grad_ref|}, within the tolerance: each
        tensor's for a sum model, the median's and the worst's for a model
        with min/max aggregation)."""
        ratio, ok = {}, True
        for k, want in reference.items():
            err = float((card_grads[k] - want).abs().max())
            scale = float(want.abs().max())
            ok &= err <= GRAD_REL_TO_MAX * scale + GRAD_ATOL
            ratio[k] = err / max(scale, 1e-30)
        if minmax:
            ok = (statistics.median(ratio.values()) <= MINMAX_GRAD_MEDIAN
                  and max(ratio.values()) <= MINMAX_GRAD_WORST)
        return ratio, ok

    grad_ratio, ok_grads = grad_errors(grads)
    worst = max(grad_ratio, key=grad_ratio.get)
    loss_err = abs(float(losses[0]) - cpu_loss)

    # the control: the same first step with TF32 matrix products
    tf32_model = Ultra(cfg)
    tf32_model.load_state_dict(init)
    tf32_state = init_train_state(tf32_model.cuda(), lr=LR, weight_decay=WEIGHT_DECAY)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_loss = float(step(tf32_state, graph, *on_card[0]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_ratio, tf32_ok = grad_errors(
        {k: p.grad.detach().cpu() for k, p in tf32_state.model.named_parameters()})
    tf32_worst = max(tf32_ratio, key=tf32_ratio.get)
    del tf32_model, tf32_state

    # the rounding control: the same step on the card from weights moved by
    # one unit in the last place, each up or down at random
    ulp_model = Ultra(cfg)
    ulp_model.load_state_dict(init)
    ulp_gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in ulp_model.parameters():
            sign = torch.randint(0, 2, p.shape, generator=ulp_gen).float() * 2 - 1
            p.mul_(1 + sign * 2.0**-23)
    ulp_state = init_train_state(ulp_model.cuda(), lr=LR, weight_decay=WEIGHT_DECAY)
    step(ulp_state, graph, *on_card[0])
    ulp_ratio, _ = grad_errors(
        {k: p.grad.detach().cpu() for k, p in ulp_state.model.named_parameters()}, grads)
    ulp_worst = max(ulp_ratio, key=ulp_ratio.get)
    del ulp_model, ulp_state

    for b in on_card[1:1 + WARM_STEPS]:
        losses.append(step(state, graph, *b))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat = []
    t_all = time.perf_counter()
    for b in on_card[1 + WARM_STEPS:]:
        t0 = time.perf_counter()
        losses.append(step(state, graph, *b))
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
    total_s = time.perf_counter() - t_all
    timed_counts = launch_counts()
    losses = [float(l) for l in losses]

    top = lambda ratio: dict(sorted(ratio.items(), key=lambda kv: -kv[1])[:5])
    record = {
        "batch": BATCH, "num_negative": NUM_NEGATIVE, "edges_masked_per_batch": masked,
        "sample_ms_per_batch": sample_ms,
        "step_ms_median": statistics.median(lat), "step_ms_min": min(lat),
        "step_ms_max": max(lat), "steps_per_s": TIMED_STEPS / total_s,
        "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
        "losses": losses, "launches_per_step": as_json(first_counts),
        "cpu_step_s": cpu_step_s, "cpu_loss": cpu_loss, "loss_abs_err": loss_err,
        "grad_err_over_max": {"worst": worst, "value": grad_ratio[worst],
                              "median": statistics.median(grad_ratio.values()),
                              "top": top(grad_ratio)},
        "tf32_control": {"loss_abs_err": abs(tf32_loss - cpu_loss), "worst": tf32_worst,
                         "value": tf32_ratio[tf32_worst],
                         "median": statistics.median(tf32_ratio.values()),
                         "within_tolerance": tf32_ok, "top": top(tf32_ratio)},
        "ulp_control": {"worst": ulp_worst, "value": ulp_ratio[ulp_worst],
                        "median": statistics.median(ulp_ratio.values()),
                        "top": top(ulp_ratio)},
        "tolerance": f"loss rtol {LOSS_RTOL}; " + (
            f"median over tensors of max|err| / max|grad_cpu| <= {MINMAX_GRAD_MEDIAN}, "
            f"worst <= {MINMAX_GRAD_WORST}" if minmax else
            f"per tensor max|err| <= {GRAD_REL_TO_MAX} * max|grad_cpu| + {GRAD_ATOL}"),
    }
    print(f"[{tag}] " + json.dumps(record), flush=True)

    want = per_step_launches(cfg, graph.num_nodes, graph.num_relations)
    check(first_counts == want, f"one train step launched {first_counts}, want {want}")
    check(timed_counts == times(want, TIMED_STEPS),
          f"{TIMED_STEPS} timed steps launched {timed_counts}")
    check(all(np.isfinite(losses)), f"a step's loss is not finite: {losses}")
    check(loss_err <= LOSS_RTOL * abs(cpu_loss),
          f"card loss {losses[0]!r} vs CPU {cpu_loss!r}")
    check(ok_grads, f"card and CPU gradients differ; worst {worst}: {grad_ratio[worst]!r} "
                    "of the tensor's largest entry, median "
                    f"{statistics.median(grad_ratio.values())!r}")
    return tf32_ok, timed_counts


def train_and_validate_run(split, graph, cfg):
    """``train_and_validate`` as a user calls it: one epoch of RUNNER_STEPS
    steps, filtered validation of RUNNER_VALID triples, a checkpoint; the
    kernels' launches read around it. Then ``evaluate`` of the trained model
    on the same RUNNER_VALID triples, timed, its launches read around it."""
    from ultra_tpu_torch import tasks
    from ultra_tpu_torch.data.kg import KGDataset
    from ultra_tpu_torch.train.eval import evaluate
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.train.runner import train_and_validate, triples_of

    # the graph's own triples stand in for a held-out split: this checks the
    # path, not the model's accuracy
    valid = split._replace(target_edge_index=split.target_edge_index[:, :4 * RUNNER_VALID],
                           target_edge_type=split.target_edge_type[:4 * RUNNER_VALID])
    dataset = KGDataset("fb15k237-shaped", split, valid, valid)
    filtered = {"valid": tasks.GraphIndex.build(split.target_edge_index,
                                                split.target_edge_type, split.num_nodes,
                                                split.num_relations)}
    run_cfg = {"train": {"num_epoch": 1, "batch_size": BATCH, "batch_per_epoch": RUNNER_STEPS,
                         "fast_test": RUNNER_VALID},
               "task": {"num_negative": NUM_NEGATIVE, "adversarial_temperature": 1.0,
                        "strict_negative": True},
               "optimizer": {"lr": LR}}
    workdir = ROOT / "build" / "chip_smoke" / "train"
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    best = train_and_validate(run_cfg, model, {"train": graph, "valid": graph}, dataset,
                              filtered, str(workdir), seed=0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()

    # a validation as the runner ran it, timed alone (warm: the runner's ran
    # first); it includes the relation model's precompute over all relations
    valid_launches = validation_launches(cfg, graph.num_nodes, split.num_relations,
                                         RUNNER_VALID)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = evaluate(best, graph, triples_of(valid), filtered["valid"], batch_size=BATCH,
                       limit=RUNNER_VALID)  # ranks come back to the host: synchronised
    valid_ms = 1e3 * (time.perf_counter() - t0)
    eval_counts = launch_counts()

    want = plus(times(per_step_launches(cfg, graph.num_nodes, split.num_relations),
                      RUNNER_STEPS), valid_launches)
    check(counts == want, f"train_and_validate launched {counts}, want {want}")
    check(eval_counts == valid_launches, f"validation launched {eval_counts}, "
                                         f"want {valid_launches}")
    check((workdir / "model_epoch_1.pth").exists(), "no checkpoint was written")
    check(all(torch.isfinite(p).all() for p in best.parameters()), "weights not finite")
    check(np.isfinite(metrics["mrr"]) and 0 < metrics["mrr"] <= 1, f"valid mrr {metrics}")
    batches = -(-RUNNER_VALID // BATCH)
    return {"steps": RUNNER_STEPS, "valid_triples": RUNNER_VALID, "wall_s": wall_s,
            "launches": as_json(counts), "valid_batches": batches, "valid_ms": valid_ms,
            "valid_ms_per_batch": valid_ms / batches, "valid_mrr": metrics["mrr"],
            "valid_launches": as_json(eval_counts)}, counts


def pna_serving(split, cfg):
    """Serve the PNA model (random weights from seed 0, in the reference
    .pth layout) through ``UltraPredictor.from_checkpoint``: the precompute,
    3 batches of tail and 1 of head requests, then TIMED_BATCHES warm
    batches timed; launches asserted per phase, scores of one batch held
    against the same predictor on the CPU. Returns (the ``[pna-serving]``
    record, the launches of the precompute and the 4 batches)."""
    from ultra_tpu_torch.serve import UltraPredictor
    from ultra_tpu_torch.train.loop import init_ultra_params

    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == PNA_PARAMS, f"the PNA model has {PNA_PARAMS:,} parameters, got {n_params}")
    ckpt = ROOT / "build" / "chip_smoke" / "pna_seed0.pth"
    torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    num_nodes, num_rel = split.num_nodes, split.num_relations
    dim = cfg.entity_model.input_dim
    reset_launch_counts()
    t0 = time.perf_counter()
    pred = UltraPredictor.from_checkpoint(str(ckpt), split, cfg=cfg, device="cuda",
                                          batch_size=BATCH)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    precompute_counts = launch_counts()

    rng = np.random.default_rng(2)
    h = rng.integers(0, num_nodes, TAIL_BATCHES * BATCH)
    r = rng.integers(0, num_rel // 2, TAIL_BATCHES * BATCH)
    t, r_head = rng.integers(0, num_nodes, BATCH), rng.integers(0, num_rel // 2, BATCH)
    reset_launch_counts()
    tail_s, _ = pred.predict_tails(h, r, k=TOPK)
    head_s, _ = pred.predict_heads(t, r_head, k=TOPK)
    serve_counts = launch_counts()

    reset_launch_counts()
    lat = []
    t_all = time.perf_counter()
    for _ in range(TIMED_BATCHES):
        hb, rb = rng.integers(0, num_nodes, BATCH), rng.integers(0, num_rel // 2, BATCH)
        t0 = time.perf_counter()
        pred.predict_tails(hb, rb, k=TOPK)  # returns host arrays: synchronised
        lat.append(1e3 * (time.perf_counter() - t0))
    total_s = time.perf_counter() - t_all
    timed_counts = launch_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    card = pred.score_all(h[:BATCH], r[:BATCH])
    del pred
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_pred = UltraPredictor.from_checkpoint(str(ckpt), split, cfg=cfg, device="cpu",
                                              batch_size=BATCH)
    cpu_scores = cpu_pred.score_all(h[:BATCH], r[:BATCH])
    cpu_s = time.perf_counter() - t0
    score_err = np.abs(cpu_scores - card)

    per_batch = forward_launches(cfg.entity_model, num_nodes, BATCH * dim)
    want_precompute = times(forward_launches(cfg.relation_model, num_rel,
                                             PRECOMPUTE_CHUNK * dim),
                            -(-num_rel // PRECOMPUTE_CHUNK))
    record = {
        "params": n_params, "setup_s": setup_s,
        "batch_ms_median": statistics.median(lat), "batch_ms_min": min(lat),
        "batch_ms_max": max(lat), "requests_per_s": TIMED_BATCHES * BATCH / total_s,
        "peak_mem_mib": peak_mib, "cpu_vs_card_max_abs_err": float(score_err.max()),
        "cpu_s": cpu_s, "launches_per_batch": as_json(per_batch),
        "launches": {"precompute": as_json(precompute_counts), "serve": as_json(serve_counts)},
    }
    print("[pna-serving] " + json.dumps(record), flush=True)
    check(precompute_counts == want_precompute,
          f"the PNA precompute launched {precompute_counts}, want {want_precompute}")
    check(serve_counts == times(per_batch, TAIL_BATCHES + HEAD_BATCHES),
          f"4 PNA batches launched {serve_counts}, want 4 x {per_batch}")
    check(timed_counts == times(per_batch, TIMED_BATCHES),
          f"timed PNA batches launched {timed_counts}")
    check(bool(np.isfinite(card).all() and np.isfinite(tail_s).all()
               and np.isfinite(head_s).all()), "PNA scores are not finite")
    check(bool(np.all(score_err <= SCORE_ATOL + SCORE_RTOL * np.abs(cpu_scores))),
          f"card and CPU PNA scores differ by up to {float(score_err.max())!r}")
    return record, plus(precompute_counts, serve_counts)


def conv_checks(graph, num_rel):
    """A ``max`` conv and a ``rotate`` conv (sum: B1 at twice the width) at
    F = 512 on the entity graph, on the card against the same conv on the
    CPU, forward, with random weights and inputs from a seed; each conv's
    launches are read around its card run. Returns the ``[conv]`` record."""
    from ultra_tpu_torch.models.layers import ConvConfig, GeneralizedRelationalConv

    cpu_graph = graph.to("cpu")
    gen = torch.Generator().manual_seed(3)
    x, boundary = (torch.randn(graph.num_nodes, BATCH, 64, generator=gen) for _ in range(2))
    query = torch.randn(BATCH, 64, generator=gen)
    feat = BATCH * 64
    record, ok = {}, True
    for name, kw, want in (
        ("max", dict(aggregate_func="max"), {"rspmm_minmax_fwd": {(graph.num_nodes, feat): 1}}),
        ("rotate", dict(message_func="rotate"), {"rspmm_sum_fwd": {(graph.num_nodes, 2 * feat): 1}}),
    ):
        torch.manual_seed(0)
        conv = GeneralizedRelationalConv(ConvConfig(num_relation=num_rel, **kw))
        reset_launch_counts()
        with torch.no_grad():
            got = copy.deepcopy(conv).cuda()(graph, x.cuda(), boundary.cuda(), query.cuda())
            got = got.cpu()
            counts = {k: v for k, v in launch_counts().items() if v}
            expect = conv(cpu_graph, x, boundary, query)
        err = (got - expect).abs()
        case_ok = bool(torch.isfinite(got).all() and
                       (err <= SCORE_ATOL + SCORE_RTOL * expect.abs()).all())
        case_ok &= counts == want
        ok &= case_ok
        record[name] = {"ok": case_ok, "max_abs_err": float(err.max()),
                        "launches": as_json(counts)}
    print("[conv] " + json.dumps(record), flush=True)
    check(ok, f"a conv differs between the card and the CPU, or launched other kernels: "
              f"{record}")
    return record


def sum_serving(split, cfg):
    """The serving path at full width: ultra_3g, random weights from a seed,
    written in the reference .pth layout and served from it. Returns (the
    ``[serving]`` record, the launches of the precompute and the 4
    batches)."""
    from ultra_tpu_torch.train.eval import precompute_relation_representations
    from ultra_tpu_torch.train.loop import init_ultra_params

    num_nodes, num_rel = split.num_nodes, split.num_relations
    num_direct = num_rel // 2
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 168705, f"ultra_3g has 168,705 parameters, got {n_params}")
    ckpt = ROOT / "build" / "chip_smoke" / "ultra_3g_seed0.pth"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
    del model

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    pred = serve(split, ckpt, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    precompute_counts = launch_counts()
    precompute_launches = fwd_launches(precompute_counts)
    want_precompute = len(pred.model.relation_model.layers) * -(-num_rel // PRECOMPUTE_CHUNK)

    # the precompute alone, warm, timed a few times (it ran once above, inside
    # set-up): it is mostly host time, which varies from run to run
    precompute_ms, timed_precompute_launches, deterministic = [], [], True
    for _ in range(TIMED_PRECOMPUTES):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rel_reprs = precompute_relation_representations(pred.model, pred.graph)
        torch.cuda.synchronize()
        precompute_ms.append(1e3 * (time.perf_counter() - t0))
        timed_precompute_launches.append(fwd_launches(launch_counts()))
        deterministic &= torch.equal(rel_reprs, pred.rel_reprs)

    rng = np.random.default_rng(0)
    n_tail, n_head = TAIL_BATCHES * BATCH, HEAD_BATCHES * BATCH
    h = rng.integers(0, num_nodes, n_tail)
    r = rng.integers(0, num_direct, n_tail)
    t = rng.integers(0, num_nodes, n_head)
    r_head = rng.integers(0, num_direct, n_head)
    layers = len(pred.model.entity_model.layers)

    reset_launch_counts()
    tail_s, tail_i = pred.predict_tails(h, r, k=TOPK)
    head_s, head_i = pred.predict_heads(t, r_head, k=TOPK)
    serve_counts = launch_counts()
    serve_launches = fwd_launches(serve_counts)
    want_serve = layers * (TAIL_BATCHES + HEAD_BATCHES)

    # per-batch latency and request rate, warm
    reset_launch_counts()
    lat = []
    t_all = time.perf_counter()
    for _ in range(TIMED_BATCHES):
        hb = rng.integers(0, num_nodes, BATCH)
        rb = rng.integers(0, num_direct, BATCH)
        t0 = time.perf_counter()
        pred.predict_tails(hb, rb, k=TOPK)  # returns host arrays: synchronised
        lat.append(1e3 * (time.perf_counter() - t0))
    total_s = time.perf_counter() - t_all
    timed_launches = fwd_launches(launch_counts())
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    # top-k against score_all, on the card
    full = pred.score_all(h, r)
    full_head = pred.score_all(t, r_head + num_direct)
    ok_topk = True
    for top_s, top_i, scores in ((tail_s, tail_i, full), (head_s, head_i, full_head)):
        ok_topk &= bool(np.isfinite(scores).all() and np.isfinite(top_s).all())
        want_s = -np.sort(-scores, axis=1)[:, :TOPK]
        ok_topk &= bool(np.allclose(top_s, want_s, rtol=0, atol=1e-5))
        ok_topk &= bool(np.allclose(np.take_along_axis(scores, top_i, 1), top_s,
                                    rtol=0, atol=1e-5))
    check(full.shape == (n_tail, num_nodes), f"score_all shape {full.shape}")

    # the same predictor on the CPU (plain rspmm), one batch
    cpu_pred = serve(split, ckpt, "cpu")
    cpu_scores = cpu_pred.score_all(h[:BATCH], r[:BATCH])
    score_err = np.abs(cpu_scores - full[:BATCH])
    ok_cpu = bool(np.all(score_err <= SCORE_ATOL + SCORE_RTOL * np.abs(cpu_scores)))

    serving = {
        "graph": {"V": num_nodes, "E": int(split.edge_index.shape[1]), "R": num_rel,
                  "rel_graph_E": int(pred.graph.relation_graph.csr.col.numel())},
        "setup_s": setup_s, "precompute_ms_median": statistics.median(precompute_ms),
        "precompute_ms_min": min(precompute_ms), "precompute_ms_max": max(precompute_ms),
        "batch_ms_median": statistics.median(lat), "batch_ms_min": min(lat),
        "batch_ms_max": max(lat), "requests_per_s": TIMED_BATCHES * BATCH / total_s,
        "peak_mem_mib": peak_mib, "cpu_vs_card_max_abs_err": float(score_err.max()),
        "launches": {"precompute": precompute_launches, "serve": serve_launches,
                     "timed_precompute": timed_precompute_launches,
                     "timed": timed_launches},
        "precompute_bitwise_repeatable": deterministic,
    }
    print("[serving] " + json.dumps(serving), flush=True)

    check(precompute_launches == want_precompute,
          f"precompute launched the kernel {precompute_launches} times, "
          f"want {want_precompute}")
    check(serve_launches == want_serve,
          f"serving launched the kernel {serve_launches} times, want {want_serve}")
    check(all(n == want_precompute for n in timed_precompute_launches),
          f"timed precomputes launched {timed_precompute_launches}, want {want_precompute}")
    check(timed_launches == layers * TIMED_BATCHES,
          f"timed batches launched {timed_launches}, want {layers * TIMED_BATCHES}")
    check(ok_topk, "top-k disagrees with score_all, or scores are not finite")
    check(ok_cpu, f"card and CPU scores differ by up to {float(score_err.max())!r}")
    del pred, cpu_pred
    torch.cuda.empty_cache()
    return serving, plus(precompute_counts, serve_counts)



def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)}")
    phases = parser.parse_args().phases.split(",")
    if not set(phases) <= set(PHASES):
        parser.error(f"unknown phase in {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1

    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.ops import build
    from ultra_tpu_torch.utils.benchlib import fb15k237_split, pna_config

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all(KERNELS)
    for name in KERNELS:
        build.load(name)
        usage = [l.strip() for l in logs.get(name, "").splitlines() if "registers" in l]
        print(f"[build] {name}: {'; '.join(usage)}", flush=True)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the FB15k-237-shaped "realistic" graph of bench.py (zipf relations,
    # 30 entity categories, seed 0), with its relation graph
    t0 = time.perf_counter()
    split = fb15k237_split("realistic", seed=0)
    num_rel = split.num_relations
    graph = split_to_graph(split, device="cuda")
    rel_graph = graph.relation_graph
    print(f"[graph] V={graph.num_nodes} E={graph.csr.col.numel()} R={num_rel} "
          f"relation graph: V={rel_graph.num_nodes} E={rel_graph.csr.col.numel()} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    (ROOT / "build" / "chip_smoke").mkdir(parents=True, exist_ok=True)

    cfg, pna_cfg = UltraConfig(), pna_config()  # ultra_3g, and its PNA variant
    kernels, phase_counts, failures = {}, {}, []

    def run(phase, fn):
        """Run one phase; a failure is recorded and the next phase runs."""
        if phase not in phases:
            return
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - reported below, exits non-zero
            failures.append(f"{phase}: {type(exc).__name__}: {exc}")
            traceback.print_exc()
        torch.cuda.empty_cache()
        print(f"[phase] {phase}: {time.perf_counter() - t0:.1f} s", flush=True)

    def kernel_phase():
        rows, ok = check_kernels(graph, num_rel, cfg, torch.Generator().manual_seed(0))
        kernels.update(rows)
        check(ok, "a kernel disagrees with its plain version (see the [kernel] lines)")

    def serving_phase():
        _, phase_counts["serving"] = sum_serving(split, cfg)

    def training_phase():
        tf32_ok, phase_counts["training"] = train_steps(split, graph, cfg)
        runner, phase_counts["train_and_validate"] = train_and_validate_run(split, graph, cfg)
        print("[runner] " + json.dumps(runner), flush=True)
        check(not tf32_ok, "the TF32 control passed the card-vs-CPU gradient check: the "
                           "check cannot tell a TF32 step from an f32 one")

    def pna_serving_phase():
        _, phase_counts["pna-serving"] = pna_serving(split, pna_cfg)

    def pna_training_phase():
        tf32_ok, phase_counts["pna-training"] = train_steps(split, graph, pna_cfg,
                                                           "pna-training")
        check(not tf32_ok, "the TF32 control passed the PNA card-vs-CPU gradient check")

    run("kernels", kernel_phase)
    run("serving", serving_phase)
    run("training", training_phase)
    run("pna-serving", pna_serving_phase)
    run("pna-training", pna_training_phase)
    run("conv", lambda: conv_checks(graph, num_rel))
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    if failures:
        print("chip_smoke failed:\n" + "\n".join(failures), file=sys.stderr)
        return 1
    if set(phases) != set(PHASES):
        print(f"[done] phases {phases} passed; the full run prints the result lines")
        return 0

    # each row's launches at its own shape (so on its own graph), counted in
    # each main-path run: serving, training (the timed steps) and
    # train_and_validate of the ultra_3g model, serving and training of the
    # PNA model
    for name, row in kernels.items():
        wrapper, shape = name.split("/")[0], tuple(row["out_shape"])
        row["launches_by_phase"] = {phase: counts.get(wrapper, {}).get(shape, 0)
                                    for phase, counts in phase_counts.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
        if row["on_path"]:
            check(row["launches"] > 0, f"{name} was not launched on its path")
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
