"""On-card smoke run of the PyTorch/CUDA port (``ultra_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, on one H100

It needs one CUDA card and exits non-zero without one. In order, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``ultra_tpu_torch/csrc`` with
   ``nvcc``, one process per source, all started together;
3. turns TF32 off for matrix products and convolutions;
4. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving, training and validation paths give it, for ``mul``
   and ``add`` with 10% of the weights zeroed, and times both with CUDA
   events: the forward B1 (entity graph F=512 and F=1024, relation graph
   F=512 and F=4096), B1 on the source-major CSR for the input gradient and
   B2 for the relation gradient (both graphs, F=512);
5. serves zero-shot link prediction at the full ``ultra_3g`` width (6x64
   RelNBFNet + 6x64 EntityNBFNet, distmult, sum) with random weights from a
   seed, on the FB15k-237-shaped synthetic graph, through
   ``UltraPredictor.from_checkpoint``: the precompute and a few batches of
   tail and head requests, with the kernels' launch counters read around
   each phase; its scores are compared with the same predictor on the CPU;
6. fine-tunes the same model on the same graph: batch 8, 256 strict
   negatives, easy-edge masks, AdamW. One step's loss and gradients are
   compared with the same step on the CPU (and, as a control of that check,
   the same step with TF32 matrix products); a few warm steps and then timed
   ones give step time, steps/s and peak memory, with the launches of each
   kernel on each graph per step asserted; then ``train_and_validate`` runs
   a short epoch with filtered validation and a checkpoint, its launches
   read around it, and a timed filtered validation of the trained model;
7. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line.

Any failed check raises before the last line is printed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

BATCH = 8  # config/transductive/inference.yaml train.batch_size
TOPK = 10
TAIL_BATCHES, HEAD_BATCHES, TIMED_BATCHES = 3, 1, 20
TIMED_PRECOMPUTES = 5
PRECOMPUTE_CHUNK = 64  # train/eval.py precompute_relation_representations
KERNELS = ("rspmm_sum_fwd", "rspmm_sum_drel")  # the sources in ultra_tpu_torch/csrc

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


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rspmm_bound_ms(csr, edge_weight, relation, x):
    """Least time for one sum rspmm on these inputs: each input read once
    (x, relation, the CSR and the weight of each CSR edge), the output
    written once, and 3 f32 operations per feature of each edge whose weight
    is not 0. Returns (ms, "bytes" | "operations")."""
    from ultra_tpu_torch.utils.benchlib import H100_BYTES_PER_S, H100_F32_FLOPS

    num_rows, feat = csr.rowptr.numel() - 1, x.shape[1]
    num_edges = csr.col.numel()
    live = int((edge_weight[csr.eid.long()] != 0).sum())
    nbytes = 4 * (x.numel() + relation.numel() + num_rows * feat)
    nbytes += 8 * (num_rows + 1) + (4 + 4 + 4 + 4) * num_edges
    flops = 3 * live * feat
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def drel_bound_ms(seg, edge_weight, x, g):
    """Least time for one relation gradient (mul) on these inputs: x, g and
    the segments (src, dst, eid and the weight of each edge, the chunk
    tables) read once, d_rel written once, and 3 f32 operations per feature
    of each edge whose weight is not 0. Returns (ms, "bytes" | "operations")."""
    from ultra_tpu_torch.utils.benchlib import H100_BYTES_PER_S, H100_F32_FLOPS

    feat, num_edges = g.shape[1], seg.src.numel()
    live = int((edge_weight[seg.eid.long()] != 0).sum())
    nbytes = 4 * (x.numel() + g.numel() + seg.num_types * feat) + 16 * num_edges
    nbytes += 8 * (seg.chunkptr.numel() + seg.type_chunkptr.numel())
    flops = 3 * live * feat
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def hold(name, source, replaces, kernel, plain, layout, weight, a, b, bound):
    """``kernel(layout, weight, a, b, mul)`` against ``plain`` on the same
    inputs in f64, for mul and add, within KERNEL_REL_TO_ABS_SUM of the sum
    of the absolute terms (``plain`` on absolute inputs) plus KERNEL_ATOL;
    times both (``plain`` in f32, as the path would run it) for mul.
    Returns (row of the kernels line, ok)."""
    from ultra_tpu_torch.utils.benchlib import device_ms

    w64, a64, b64 = weight.double(), a.double(), b.double()
    max_abs, max_rel, ok = 0.0, 0.0, True
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
        max_abs, max_rel = max(max_abs, float(err.max())), max(max_rel, rel)
        print(f"[kernel] {name} mul={mul} {tuple(got.shape)}: ok={case_ok} "
              f"max_abs_err={float(err.max())!r} max_rel_err={rel!r} "
              f"worst_err_over_tolerance={float(within.max())!r}", flush=True)

    ms = device_ms(lambda: kernel(layout, weight, a, b, "mul"))
    plain_ms = device_ms(lambda: plain(layout, weight, a, b, "mul"))
    bound_ms, bound_by = bound(layout, weight, a, b)
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "shape": {"out": list(got.shape), "a": list(a.shape), "b": list(b.shape),
                  "edges": int(weight.numel())},
        "tolerance": f"|err| <= {KERNEL_REL_TO_ABS_SUM} * sum|terms| + {KERNEL_ATOL} "
                     "against the plain version in f64",
    }
    print(f"[kernel] {name}: ms={ms!r} plain_ms={plain_ms!r} bound_ms={bound_ms!r} "
          f"({bound_by})", flush=True)
    return row, ok


def check_kernels(graph, num_rel, cfg, gen):
    """Every kernel wrapper against its plain version at each shape the
    serving, training and validation paths give it: F = 512 (a batch of 8,
    D = 64) for training and serving, 1024 for validation's two directions
    on the entity graph, 4096 for the precompute's 64 relations on the
    relation graph. Returns ({row name: row}, ok); a row's
    ``shape["out"]`` is the launch-count key of its launches."""
    from ultra_tpu_torch.ops import rspmm_cuda as k

    fwd_src, drel_src = (f"ultra_tpu_torch/csrc/{n}.cu" for n in KERNELS)
    dim = cfg.entity_model.input_dim
    train_feat = BATCH * dim
    rows, ok = {}, True
    # the TPU kernels each launch site replaces: on the TPU the input gradient
    # is the forward kernel on the source plan (rspmm_pallas.py:1341-1374)
    # and the relation gradient the v2 or the v1 kernel (:1375-1392)
    for tag, g_, rel_rows, fwd_feats, fwd_replaces, drel_replaces in (
        ("entity", graph, num_rel, (train_feat, 2 * train_feat),
         "ultra_tpu/ops/rspmm_pallas_v2.py:508", "ultra_tpu/ops/rspmm_pallas_v2.py:1054"),
        ("relation", graph.relation_graph, graph.relation_graph.num_relations,
         (train_feat, PRECOMPUTE_CHUNK * dim), "ultra_tpu/ops/rspmm_pallas.py:283",
         "ultra_tpu/ops/rspmm_pallas.py:381"),
    ):
        keep = torch.rand(g_.edge_weight.shape, generator=gen) >= 0.1
        w = (g_.edge_weight.cpu() * keep).cuda()
        rand = lambda *shape: torch.randn(*shape, generator=gen).cuda()
        cases = [
            (f"rspmm_sum_fwd/{tag}/F{feat}", fwd_src, fwd_replaces, k.rspmm_sum_fwd,
             k.rspmm_sum_fwd_plain, g_.csr, rand(rel_rows, feat),
             rand(g_.num_nodes, feat), rspmm_bound_ms)
            for feat in fwd_feats
        ] + [
            (f"rspmm_sum_dx/{tag}/F{train_feat}", fwd_src, fwd_replaces, k.rspmm_sum_dx,
             k.rspmm_sum_dx_plain, g_.csr_src, rand(rel_rows, train_feat),
             rand(g_.num_nodes, train_feat), rspmm_bound_ms),
            (f"rspmm_sum_drel/{tag}/F{train_feat}", drel_src, drel_replaces,
             k.rspmm_sum_drel, k.rspmm_sum_drel_plain, g_.segments,
             rand(g_.num_nodes, train_feat), rand(g_.num_nodes, train_feat), drel_bound_ms),
        ]
        for name, source, replaces, kernel, plain, layout, a, b, bound in cases:
            rows[name], case_ok = hold(name, source, replaces, kernel, plain, layout, w,
                                       a, b, bound)
            ok &= case_ok
    return rows, ok


def serve(split, ckpt, device):
    from ultra_tpu_torch.serve import UltraPredictor

    return UltraPredictor.from_checkpoint(str(ckpt), split, device=device,
                                          batch_size=BATCH)


def wrappers():
    from ultra_tpu_torch.ops import rspmm_cuda as k

    return k.rspmm_sum_fwd, k.rspmm_sum_dx, k.rspmm_sum_drel


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


def per_step_launches(cfg, num_nodes, num_rel):
    """What autograd asks of the rspmm in one step, by output shape: a
    forward, a relation gradient and an input gradient per layer of both
    models, except the input gradient of the relation model's first layer,
    whose input is a constant boundary. The relation graph has ``num_rel``
    nodes and 4 edge types; the entity graph ``num_nodes`` nodes and
    ``num_rel`` edge types."""
    rel, ent = (len(m.hidden_dims) for m in (cfg.relation_model, cfg.entity_model))
    feat = BATCH * cfg.entity_model.input_dim
    return {"rspmm_sum_fwd": {(num_nodes, feat): ent, (num_rel, feat): rel},
            "rspmm_sum_dx": {(num_nodes, feat): ent, (num_rel, feat): rel - 1},
            "rspmm_sum_drel": {(num_rel, feat): ent, (4, feat): rel}}


def validation_launches(cfg, num_nodes, num_rel, num_triples):
    """B1 launches of a filtered validation of ``num_triples`` triples
    (train/eval.py::collect_rankings), by output shape. With few batches,
    each direction of each batch runs both models; with many, the relation
    model runs once per chunk of 64 relations and both directions share one
    entity-model pass per batch."""
    rel, ent = (len(m.hidden_dims) for m in (cfg.relation_model, cfg.entity_model))
    dim = cfg.entity_model.input_dim
    batches = -(-num_triples // BATCH)
    if num_triples / BATCH > num_rel / PRECOMPUTE_CHUNK:
        fwd = {(num_rel, PRECOMPUTE_CHUNK * dim): rel * -(-num_rel // PRECOMPUTE_CHUNK),
               (num_nodes, 2 * BATCH * dim): ent * batches}
    else:
        fwd = {(num_rel, BATCH * dim): 2 * rel * batches,
               (num_nodes, BATCH * dim): 2 * ent * batches}
    return {"rspmm_sum_fwd": fwd, "rspmm_sum_dx": {}, "rspmm_sum_drel": {}}


def train_steps(split, graph, cfg):
    """One step held against the same step on the CPU, the same step with
    TF32 matrix products as a control of that comparison, then WARM_STEPS
    warm and TIMED_STEPS timed steps on the card, each with its own sampled
    batch and easy-edge mask. Returns (the ``[training]`` record, the TF32
    control's worst gradient error over its tensor's largest entry)."""
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

    def grad_errors(card_grads):
        """({tensor: max|err| / max|grad_cpu|}, all within the tolerance)."""
        ratio, ok = {}, True
        for k, want in cpu_grads.items():
            err = float((card_grads[k] - want).abs().max())
            scale = float(want.abs().max())
            ok &= err <= GRAD_REL_TO_MAX * scale + GRAD_ATOL
            ratio[k] = err / max(scale, 1e-30)
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

    want = per_step_launches(cfg, graph.num_nodes, graph.num_relations)
    check(first_counts == want, f"one train step launched {first_counts}, want {want}")
    check(timed_counts == times(want, TIMED_STEPS),
          f"{TIMED_STEPS} timed steps launched {timed_counts}")
    check(all(np.isfinite(losses)), f"a step's loss is not finite: {losses}")
    check(loss_err <= LOSS_RTOL * abs(cpu_loss),
          f"card loss {losses[0]!r} vs CPU {cpu_loss!r}")
    check(ok_grads, f"card and CPU gradients differ; worst {worst}: {grad_ratio[worst]!r} "
                    "of the tensor's largest entry")
    return {
        "batch": BATCH, "num_negative": NUM_NEGATIVE, "edges_masked_per_batch": masked,
        "sample_ms_per_batch": sample_ms,
        "step_ms_median": statistics.median(lat), "step_ms_min": min(lat),
        "step_ms_max": max(lat), "steps_per_s": TIMED_STEPS / total_s,
        "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
        "losses": losses, "launches_per_step": as_json(first_counts),
        "cpu_step_s": cpu_step_s, "cpu_loss": cpu_loss, "loss_abs_err": loss_err,
        "grad_err_over_max": {"worst": worst, "value": grad_ratio[worst],
                              "median": statistics.median(grad_ratio.values())},
        "tf32_control": {"loss_abs_err": abs(tf32_loss - cpu_loss), "worst": tf32_worst,
                         "value": tf32_ratio[tf32_worst],
                         "median": statistics.median(tf32_ratio.values()),
                         "within_tolerance": tf32_ok},
        "tolerance": f"loss rtol {LOSS_RTOL}; per tensor max|err| <= "
                     f"{GRAD_REL_TO_MAX} * max|grad_cpu| + {GRAD_ATOL}",
    }, tf32_ok


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1

    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.ops import build
    from ultra_tpu_torch.train.eval import precompute_relation_representations
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.utils.benchlib import fb15k237_split

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
    num_nodes, num_rel = split.num_nodes, split.num_relations
    num_direct = num_rel // 2
    graph = split_to_graph(split, device="cuda")
    rel_graph = graph.relation_graph
    print(f"[graph] V={graph.num_nodes} E={graph.csr.col.numel()} R={num_rel} "
          f"relation graph: V={rel_graph.num_nodes} E={rel_graph.csr.col.numel()} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 4. each kernel against its plain version at the paths' shapes
    cfg = UltraConfig()
    kernels, ok_kernels = check_kernels(graph, num_rel, cfg, torch.Generator().manual_seed(0))
    torch.cuda.empty_cache()

    # 5. the serving path at full width: ultra_3g, random weights from a seed,
    # written in the reference .pth layout and served from it
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

    check(ok_kernels, "a kernel disagrees with its plain version (see the [kernel] lines)")
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

    # 6. fine-tuning: the step, timed and held against the CPU; then the runner
    training, tf32_ok = train_steps(split, graph, cfg)
    print("[training] " + json.dumps(training), flush=True)
    runner, runner_counts = train_and_validate_run(split, graph, cfg)
    print("[runner] " + json.dumps(runner), flush=True)
    check(not tf32_ok, "the TF32 control passed the card-vs-CPU gradient check: the "
                       "check cannot tell a TF32 step from an f32 one")

    # each row's launches at its own shape (so on its own graph): on the
    # serving path (precompute and 4 batches) for the shapes serving runs,
    # else in the train_and_validate run
    serving_counts = plus(precompute_counts, serve_counts)
    for name, row in kernels.items():
        wrapper, shape = name.split("/")[0], tuple(row["shape"]["out"])
        row["launches_train_and_validate"] = runner_counts[wrapper].get(shape, 0)
        row["launches_serving"] = serving_counts[wrapper].get(shape, 0)
        row["launches"] = row["launches_serving"] or row["launches_train_and_validate"]
        check(row["launches"] > 0, f"{name} was not launched on its path")
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
