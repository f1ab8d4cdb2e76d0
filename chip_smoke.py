"""On-card smoke run of the PyTorch/CUDA port (``ultra_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, on one H100

It needs one CUDA card and exits non-zero without one. In order, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernel from ``ultra_tpu_torch/csrc`` with
   ``nvcc``;
3. turns TF32 off for matrix products and convolutions;
4. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (entity graph F=512, relation graph
   F=4096), for ``mul`` and ``add`` with 10% of the weights zeroed, and times
   both with CUDA events;
5. serves zero-shot link prediction at the full ``ultra_3g`` width (6x64
   RelNBFNet + 6x64 EntityNBFNet, distmult, sum) with random weights from a
   seed, on the FB15k-237-shaped synthetic graph, through
   ``UltraPredictor.from_checkpoint``: the precompute and a few batches of
   tail and head requests, with the kernels' launch counters read around
   each phase; its scores are compared with the same predictor on the CPU;
6. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
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

# Kernel vs plain on the card: both sum each row's messages in f32, in
# different orders (CSR order in registers vs atomics in index_add_). The
# rounding of a sum is bounded by a multiple of eps(f32) = 1.19e-7 times the
# sum of the absolute values of its terms, so the bound per element is
# 1e-5 (84 eps) times that sum, plus 1e-6.
KERNEL_REL_TO_ABS_SUM, KERNEL_ATOL = 1e-5, 1e-6
# Served scores, card vs CPU: 12 layers of f32 with cuBLAS and the CPU's
# matrix products and sums in different orders.
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-4


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


def check_rspmm(name, graph, num_rel_rows, feat, replaces, gen):
    """Kernel vs plain on ``graph``'s CSR at width ``feat``, for mul and add,
    with 10% of the edge weights zeroed at run time; times the mul case."""
    from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_fwd, rspmm_sum_fwd_plain
    from ultra_tpu_torch.utils.benchlib import device_ms

    dev = graph.device
    csr = graph.csr
    keep = torch.rand(graph.edge_weight.shape, generator=gen) >= 0.1
    weight = (graph.edge_weight.cpu() * keep).to(dev)
    x = torch.randn(graph.num_nodes, feat, generator=gen).to(dev)
    rel = torch.randn(num_rel_rows, feat, generator=gen).to(dev)

    max_abs, max_rel, ok = 0.0, 0.0, True
    for mul in ("mul", "add"):
        got = rspmm_sum_fwd(csr, weight, rel, x, mul)
        want = rspmm_sum_fwd_plain(csr, weight, rel, x, mul)
        abs_sum = rspmm_sum_fwd_plain(csr, weight.abs(), rel.abs(), x.abs(), mul)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok &= bool((err <= KERNEL_REL_TO_ABS_SUM * abs_sum + KERNEL_ATOL).all())
        ok &= bool(torch.isfinite(got).all())
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float(err.max() / want.abs().max().clamp_min(1e-30)))
        print(f"[kernel] {name} mul={mul} F={feat}: max_abs_err={float(err.max())!r} "
              f"max_rel_err={float(err.max() / want.abs().max())!r}", flush=True)

    ms = device_ms(lambda: rspmm_sum_fwd(csr, weight, rel, x, "mul"))
    plain_ms = device_ms(lambda: rspmm_sum_fwd_plain(csr, weight, rel, x, "mul"))
    bound_ms, bound_by = rspmm_bound_ms(csr, weight, rel, x)
    row = {
        "name": name, "route": "cuda",
        "source": "ultra_tpu_torch/csrc/rspmm_sum_fwd.cu", "replaces": replaces,
        "launches": None, "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "shape": {"rows": csr.rowptr.numel() - 1, "x_rows": graph.num_nodes,
                  "rel_rows": num_rel_rows, "F": feat, "edges": csr.col.numel()},
        "tolerance": f"|err| <= {KERNEL_REL_TO_ABS_SUM} * sum|terms| + {KERNEL_ATOL}",
    }
    print(f"[kernel] {name}: ms={ms!r} plain_ms={plain_ms!r} bound_ms={bound_ms!r} "
          f"({bound_by})", flush=True)
    return row, ok


def serve(split, ckpt, device):
    from ultra_tpu_torch.serve import UltraPredictor

    return UltraPredictor.from_checkpoint(str(ckpt), split, device=device,
                                          batch_size=BATCH)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1

    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.ops import build
    from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_fwd
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
    build.load("rspmm_sum_fwd")
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

    # 4. each kernel against its plain version at the serving path's shapes
    gen = torch.Generator().manual_seed(0)
    cfg = UltraConfig()
    d = cfg.entity_model.input_dim
    rows, ok_entity = check_rspmm(
        "rspmm_sum_fwd/entity", graph, num_rel, BATCH * d,
        "ultra_tpu/ops/rspmm_pallas_v2.py:508", gen)
    kernels = [rows]
    rows, ok_relation = check_rspmm(
        "rspmm_sum_fwd/relation", rel_graph, rel_graph.num_relations,
        PRECOMPUTE_CHUNK * cfg.relation_model.input_dim,
        "ultra_tpu/ops/rspmm_pallas.py:283", gen)
    kernels.append(rows)
    del graph, rel_graph
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
    rspmm_sum_fwd.launches = 0
    t0 = time.perf_counter()
    pred = serve(split, ckpt, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    precompute_launches = rspmm_sum_fwd.launches
    want_precompute = len(pred.model.relation_model.layers) * -(-num_rel // PRECOMPUTE_CHUNK)

    # the precompute alone, warm, timed a few times (it ran once above, inside
    # set-up): it is mostly host time, which varies from run to run
    precompute_ms, timed_precompute_launches, deterministic = [], [], True
    for _ in range(TIMED_PRECOMPUTES):
        rspmm_sum_fwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rel_reprs = precompute_relation_representations(pred.model, pred.graph)
        torch.cuda.synchronize()
        precompute_ms.append(1e3 * (time.perf_counter() - t0))
        timed_precompute_launches.append(rspmm_sum_fwd.launches)
        deterministic &= torch.equal(rel_reprs, pred.rel_reprs)

    rng = np.random.default_rng(0)
    n_tail, n_head = TAIL_BATCHES * BATCH, HEAD_BATCHES * BATCH
    h = rng.integers(0, num_nodes, n_tail)
    r = rng.integers(0, num_direct, n_tail)
    t = rng.integers(0, num_nodes, n_head)
    r_head = rng.integers(0, num_direct, n_head)
    layers = len(pred.model.entity_model.layers)

    rspmm_sum_fwd.launches = 0
    tail_s, tail_i = pred.predict_tails(h, r, k=TOPK)
    head_s, head_i = pred.predict_heads(t, r_head, k=TOPK)
    serve_launches = rspmm_sum_fwd.launches
    want_serve = layers * (TAIL_BATCHES + HEAD_BATCHES)

    # per-batch latency and request rate, warm
    rspmm_sum_fwd.launches = 0
    lat = []
    t_all = time.perf_counter()
    for _ in range(TIMED_BATCHES):
        hb = rng.integers(0, num_nodes, BATCH)
        rb = rng.integers(0, num_direct, BATCH)
        t0 = time.perf_counter()
        pred.predict_tails(hb, rb, k=TOPK)  # returns host arrays: synchronised
        lat.append(1e3 * (time.perf_counter() - t0))
    total_s = time.perf_counter() - t_all
    timed_launches = rspmm_sum_fwd.launches
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

    check(ok_entity, "kernel disagrees with its plain version on the entity graph")
    check(ok_relation, "kernel disagrees with its plain version on the relation graph")
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

    kernels[0]["launches"] = serve_launches
    kernels[1]["launches"] = precompute_launches
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
