"""On-card smoke run of the PyTorch/CUDA port (``ultra_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, on one H100

It needs one CUDA card and exits non-zero without one. In order, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``ultra_tpu_torch/csrc`` with
   ``nvcc``, one process per source, all started together;
3. turns TF32 off for matrix products and convolutions;
4. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving, training, validation and attribution paths give it,
   and times both with CUDA events: the sum forward B1 (entity graph F=512
   and F=1024, relation graph F=512 and F=4096, both graphs at
   attribution's F=64), B1 on the source-major CSR for the input gradient
   (both graphs at F=512, the entity graph at F=64) and B2 for the relation
   gradient (both graphs, F=512; B2 timed for ``mul`` and ``add``), for
   ``mul`` and ``add`` with 10% of
   the weights zeroed; and the min/max kernels B3 (forward), B4 (input
   gradient) and B5 (relation gradient) on both graphs at F=512, for each
   ``mul`` and each of min and max, on tie-heavy inputs and on normal ones;
   the edge-weight gradient B6 on the entity graph at F=64 (attribution)
   and F=512, for the sum and for min and max, on those inputs; B1
   (forward on both graphs, input gradient) and B6 at F=64 on the repo's
   rule-KG, which ``[visualize]`` explains a prediction on, and B1 and B2
   at F=512 on it and on its relation graph, ``[link-prediction]``'s
   training graph; and B1 at
   validation's widths (F=1024 on the entity graph, 4096 on the relation
   graph) on ``[link-prediction]``'s inference graph; and B1 at
   ``[clqa]``'s widths on its query graph (F=512 on the entity graph, 4096
   on the relation graph); and B1 (forward and input gradient) and B2 at
   the training paths' widths: on each ``[pretrain]`` member and its
   relation graph at a batch of 32 (F=2048) and at validation's widths,
   and on ``[clqa-training]``'s query graph and its relation graph at a
   batch of 8 (F=512) and a micro-batch of 4. B1, B3, B4 and B6 walk their CSR's piece table (``graph.ROW_PIECE``) and B2 and B5 the
   type segments' (``graph.segment_piece``): B1, B3, B4 and B6 are also
   timed on a graph with uniformly drawn destinations (``uniform_ms``), all
   six are held against their plain versions on layouts whose rows sit on
   each side of a piece's length (B6 also at F=16,384), and two launches
   each of B1, B2, B4, B5 and B6 must give the same bits; and the conv
   epilogue E1 (layer norm, ReLU and the short cut in one pass) at the
   ranking cell's entity pass (123,182 nodes x 16 queries) and the
   FB15k-237 entity graph's (a batch of 8), against its plain twin, beside
   the composed PyTorch ops;
5. serves zero-shot link prediction at the full ``ultra_3g`` width (6x64
   RelNBFNet + 6x64 EntityNBFNet, distmult, sum) with random weights from a
   seed, on the FB15k-237-shaped synthetic graph, through
   ``UltraPredictor.from_checkpoint``: the precompute and a few batches of
   tail and head requests, with the kernels' launch counters read around
   each phase (E2, the conv's tail: 6 launches a pass of either model); its
   scores are compared with the same predictor on the CPU;
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
   bound on the median over the tensors (see MINMAX_GRAD_MEDIAN), on a
   batch of PNA_CHECK_BATCH rows; its serving ends each PNA layer with E1
   and each relation layer with E2;
8. holds the conv's tail E2 (the linear of ``[input | update]``, layer
   norm, ReLU and the short cut in one pass) against its plain twin at the
   ranking cell's entity pass, the evaluation cell's (14,505 nodes x 32
   queries), a FB15k-237 batch of 8, the precompute's 474 x 64 rows and the
   ranking cell's 74 x 64, timed beside the twin and the ops it replaced
   (``torch.cat``, ``F.linear`` and E1), one launch a call asserted; then a
   ``max`` conv and a ``rotate`` conv (its sum runs B1 at twice the width)
   on the card against the same conv on the CPU, each ended by one E2;
   and (``[boundary-rows]``) the boundary added as its rows at the ranking
   cell's shape (see RANKING_GRAPH): the relation model and every hidden
   state of the entity pass with the rows the same bits as without them,
   and the pass's six ``index_add_`` calls timed beside its six dense adds;
   and (``[scorer]``) the scorer S1 (the scoring MLP over [hidden | query]
   in one pass) against its plain twin, the composed ops, at the ranking
   cell's, the evaluation cell's and a FB15k-237 batch's shapes and a
   ragged one, timed beside them, one launch a call asserted, with the
   blocks an SM holds (``[serving]`` and ``[pna-serving]`` assert its
   launch a batch);
9. runs ``compute_dtype: bfloat16`` (``[bf16]``, see BF16_REL): the bf16
   instances of B1-B6 against their plain versions in f64 on the same bf16
   operands, each timed beside the f32 instance (with the ratio of the two
   times and ``f32_equal``, their largest difference from the f32 instance
   on the same values: 0 where the two compute in the same order, as the
   8-feature walk of every bf16 instance does, and held to 0 for B3-B6);
   then ultra_3g
   serving and fine-tuning, the PNA model's scores and step (the step also
   against the same step on the plain versions), attribution and a CLQA
   batch, each in bf16 against f32 from the same weights and inputs, with their launches
   asserted (no f32 instance may run); and a bf16 conv against the CPU;
10. explains predictions (``[visualize]``): the edge gradients of the
   ``ultra_3g`` model for 4 queries on the FB15k-237-shaped graph, held
   against the same call on the CPU (and a TF32 control that must fail that
   check), with the launches of each call asserted, and one call of the PNA
   model the same way, with its peak memory; then the full ``visualize``
   through the function ``scripts/torch_visualize.py`` runs, on the repo's
   rule-KG ``kg-datasets/synthrule-v5000-b12-c6-e45000-s3``, from a
   ``.pth``, against the CPU; and the command line itself where PyYAML is
   installed, in its own process while this one runs the CPU references;
11. runs link prediction (``[link-prediction]``) as
   ``scripts/torch_run.py`` runs it with ``config/inductive/inference.yaml``
   (``train/runner.py::run_link_prediction``), on a fully inductive dataset
   in InGram's layout written from the repo's two rule-KGs (see
   LP_INFERENCE), from a ``.pth`` of random weights: zero-shot, and a
   fine-tune of one short epoch, each timed with its launches asserted;
   the card's ranks of a few test triples held against the CPU's, with the
   random weights and with the fine-tuned checkpoint; and the
   command line itself where PyYAML is installed, in its own process while
   this one runs the CPU references, whose test metrics must be the
   zero-shot run's;
12. answers complex queries zero-shot (``[clqa]``) as
   ``scripts/torch_run_query.py`` runs
   ``config/ultraquery/transductive_synth.yaml`` (its ``run``), on the
   repo's BetaE-format dataset (see CLQA_ROOT), from a ``.pth`` of random
   weights in UltraQuery's layout: every valid and test query, timed, with
   the launches of B1 asserted against the projection schedule; the card's
   ranks of a few test queries of each type held against the CPU's; and
   the HTTP server (``ultra_tpu_torch/server.py``) on the card over the
   same graph: both endpoints against direct calls, malformed requests
   refused with 400, and each endpoint's median latency;
13. pretrains on a mixture (``[pretrain]``) as ``scripts/torch_pretrain.py``
   runs ``config/transductive/pretrain_synth.yaml`` (its ``run``; the repo's
   three rule-KGs, batch 32, 128 strict negatives, validation of 300
   triples a member) for one epoch of a few dozen steps, timed, its
   launches read around it; then steps on each member, timed with their
   peak memory and the host's sampling, the first timed step's launches
   asserted, and one step of the smallest member held against the CPU;
14. trains UltraQuery (``[clqa-training]``) as ``scripts/torch_run_query.py``
   runs ``transductive_synth.yaml`` with ``--epochs 1`` (its ``run``), per
   slot and with grouped projections and grad_accum 2, each run's launches
   held against the projection schedules of its steps and evaluations;
   each kind of query step (per slot, grouped, grouped with grad_accum 2)
   held against the same step on the CPU on the same dropout plan, then
   timed with its host planning and peak memory, its launches asserted;
   and ``pretrain_queries`` over a ``JointQueryDataset`` of the repo's set
   and a member written by ``data/synthetic_queries.py``;
15. runs multi-process training (``[distributed]``, see DIST_STEPS): a
   1-rank group (nccl) through ``train_distributed`` and
   ``evaluate_distributed`` at ultra_3g width on the FB15k-237-shaped graph
   against the same schedule in one process; then 2 ranks over gloo on the
   one card, as subprocesses of this script: data=2 steps, edge=2 score and
   train steps (sum, and PNA at a small batch: B1-B5 on each rank's block of
   the edges) and a data=2 grouped query step, each against the same global
   batch in one process, with each rank's launches, milliseconds a step and
   bytes and milliseconds of all-reduce a step;
16. runs the gather probe (``[gather-probe]``,
   ``utils/benchlib.py::gather_probe``, the function
   ``scripts/torch_gather_probe.py`` runs): G1 and G2 at the TPU probes'
   shapes and G1 over the entity graph's edge sources, each equal to its
   plain version, timed beside it and the PyTorch call that computes the
   same function; G2 also at 2, 4 and 8 lanes a thread, beside an empty
   kernel on its grid (the floor under G2) and on the grid it took before
   its redesign, and beside its walk storing its indices alone;
17. holds the modules the port took over last (``[tooling]``, see
   NATIVE_DROP): the native join of the graph of relations against the
   numpy join on five graphs, both timed; the ragged-set ops and
   ``spmm_max`` on the card against the CPU; a ``utils/profiling.py`` trace
   of one serving batch (B1's kernel events against its launch counter)
   and ``StepTimer`` against CUDA events; the two parity command lines
   against ``[link-prediction]``'s and ``[clqa]``'s metrics; and the
   supervisor's probe and a supervised fine-tuning whose child is killed
   once and resumes from its crash checkpoint;
18. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line.

Any failed check raises before the last line is printed.
``--phases`` runs a subset (for example ``--phases kernels`` to build and
check the kernels alone); the last line is then not printed.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ultra_tpu_torch.utils.benchlib import bound_ms, live_edges, rspmm_bound_ms, tensor_bytes

ROOT = Path(__file__).resolve().parent

BATCH = 8  # config/transductive/inference.yaml train.batch_size
TOPK = 10
TAIL_BATCHES, HEAD_BATCHES, TIMED_BATCHES = 3, 1, 20
TIMED_PRECOMPUTES = 5
PRECOMPUTE_CHUNK = 64  # train/eval.py precompute_relation_representations
# the sources in ultra_tpu_torch/csrc
KERNELS = ("rspmm_sum_fwd", "rspmm_sum_drel", "rspmm_minmax_fwd", "rspmm_minmax_dx",
           "rspmm_minmax_drel", "rspmm_dw", "gather", "conv_epilogue", "conv_tail",
           "mlp_score")
PHASES = ("kernels", "serving", "training", "pna-serving", "pna-training", "conv", "bf16",
          "visualize", "link-prediction", "clqa", "pretrain", "clqa-training", "distributed",
          "gather-probe", "tooling", "boundary-rows", "scorer")
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
# E1 against its plain twin: max |err| over the output's largest |value|
# (both f32 layer norms, reduced in other orders)
EPILOGUE_REL_TOL = 2e-6
# E1's rows: (tag, rows, on a path of this script): the ranking cell's
# entity pass (YAGO3-10's 123,182 nodes x 16 queries; the benchmark runs
# it), and the FB15k-237-shaped graph's at a batch of 8 ([serving])
EPILOGUE_SHAPES = (("ranking", 123_182 * 2 * 8, False), ("fb15k237", 14_541 * 8, True))
# E2 against its plain twin: max |err| over the output's largest |value|
# (tests/test_torch_conv_tail.py: the 128 products of a row and the layer
# norm summed in other orders)
CONV_TAIL_REL_TOL = 1e-5
# E2's rows: (tag, rows, on a path of this script): the ranking cell's entity
# pass, the evaluation cell's (14,505 nodes x 32 queries), the FB15k-237
# graph's at a batch of 8 ([serving]), the precompute's 474 relations x 64
# ([serving]) and the ranking cell's 74 x 64
CONV_TAIL_SHAPES = (("ranking", 123_182 * 16, False), ("eval", 14_505 * 32, False),
                    ("fb15k237", 14_541 * 8, True), ("precompute", 474 * 64, True),
                    ("ranking-precompute", 74 * 64, False))
# E2's bf16-x instance (compute_dtype: bfloat16; the linear reads x rounded to
# bf16): the bf16 ranking cell's entity pass, timed beside the f32 instance
CONV_TAIL_BF16_X_SHAPES = (("ranking", 123_182 * 16, False),)
# S1, the scorer, against its plain twin: max |err| over the logits' largest
# |value| (tests/test_torch_mlp_score.py: a row's products summed in other
# orders, E2's tolerance)
SCORER_REL_TOL = 1e-5
# S1's shapes: (tag, nodes, queries, on a path of this script): the ranking
# cell's entity pass (1,970,912 rows), the evaluation cell's (464,160), the
# FB15k-237 graph's at a batch of 8 ([serving]; 116,328), and a ragged count
# whose last tile is mostly past the end
SCORER_SHAPES = (("ranking", 123_182, 16, False), ("eval", 14_505, 32, False),
                 ("fb15k237", 14_541, 8, True), ("ragged", 1_001, 3, False))
# the phases that read S1's launches (layer_ends), whose batches of 8 on
# FB15k-237 give the on-path shape
SCORER_PHASES = ("serving", "pna-serving")
# the acceptance of S1 at the ranking cell's shape: at most this many ms, and
# at most this share of the composed ops' time in the same run
SCORER_RANKING_MS, SCORER_RANKING_RATIO = 1.1, 1 / 3
# [boundary-rows]: the ranking cell's graph (YAGO3-10's shape: 123,182
# entities, 37 direct relations, 1,079,040 training triples, Zipf relations,
# 30 categories; benchmark/traffic/rank.yago310.json) and its entity pass of
# 16 queries, 8 triples both ways
RANKING_GRAPH = dict(num_nodes=123_182, num_direct_rel=37, num_triples=1_079_040,
                     rel_dist="zipf", categories=30)
RANKING_QUERIES = 16
# A plain version's time is the reference a kernel is read against, not a
# result: the median of 5 runs of 10 calls, where a kernel's takes 20
PLAIN_SAMPLES = 5
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
# The PNA step held against the CPU takes a batch of PNA_CHECK_BATCH rows:
# the CPU's PNA step at a full batch took 116 s of the run, and its cost
# goes with the batch. The readings above were at a full batch; at 4 rows
# on an H100 (PERF.md) the median read 8.9e-4, TF32 0.021, the moved
# weights 4.5e-4; at 2 rows 2.8e-3, too near the bound.
PNA_CHECK_BATCH = 4
# B3 against its plain version in f32: equal, value for value (a min or a
# max is exact, and both compute each message with the same two roundings);
# B4, B5 and B6 against plain versions that route in f32 exactly as the
# forward did and add in f64, within KERNEL_REL_TO_ABS_SUM * sum|terms| +
# KERNEL_ATOL. G1 and G2 copy values: equal to their plain versions.
# Attribution (models/visualize.py::edge_gradients), card vs CPU, same
# weights and query: per layer, over the live edges, max|err| <= 1e-4 of
# that layer's largest |gradient|, the bound of a train step's gradients
# (the gradient runs back through the same 12 layers); the same call with
# TF32 matrix products must fall outside it. The paths of a full visualize:
# the top path equal, its importance (an average of at most 6 such
# gradients) within rtol 1e-3.
VIS_GRAD_REL_TO_MAX, VIS_WEIGHT_RTOL = 1e-4, 1e-3
# The PNA model's attribution (max and min per edge, whose gradient shares a
# tie between the tying edges) has no such bound on its worst edge: where
# two messages nearly tie, rounding decides which edge takes the gradient.
# On an H100 (PERF.md) the card against the CPU moved 53 of 544,230 live
# edges of one layer past VIS_GRAD_REL_TO_MAX of the layer's largest (up to
# 0.0061 of it), the same call on the card from weights moved by one unit in
# the last place 8 (up to 0.0059): rounding alone sets the worst edge. With
# TF32 matrix products 956 edges of that layer moved. So per layer at most
# VIS_MINMAX_EDGES_OFF of the live edges may be past VIS_GRAD_REL_TO_MAX,
# and the TF32 control must not pass.
VIS_MINMAX_EDGES_OFF = 4e-4
VIS_QUERIES = 4
# B6 keeps no row in shared memory, so it takes any width: it is also held
# at one whose g and out rows would not fit 48 KB of it
DW_WIDE = 16384
# the in-repo rule-KG that [visualize] explains predictions on, and its
# constructor keys (kg-datasets/synthrule-v5000-b12-c6-e45000-s3: 4,326
# entities in a triple, 136,010 train triples, 272,020 message edges)
SYNTHRULE = dict(num_nodes=5000, num_base_rel=12, num_comp_rel=6, num_base_triples=45000,
                 seed=3)


# [link-prediction]: a fully inductive dataset in InGram's layout (FBIngram,
# version "synth") written from the repo's two rule-KGs. Its training graph
# is SYNTHRULE's train.txt (136,010 triples, 272,020 message edges, 36
# relations with inverses); its inference graph LP_INFERENCE's train.txt
# (90,748 triples over 3,732 entities, 54 relations with inverses), with
# every token renamed so that the graphs share none; its validation and test
# triples the first LP_TRIPLES lines of LP_INFERENCE's valid.txt and
# test.txt. Run A is zero-shot; run B fine-tunes one epoch of LP_STEPS
# batches; the card's ranks of the first LP_RANKED test triples are held
# against the CPU's.
LP_INFERENCE = "synthrule-v4000-b18-c9-e30000-s1"
LP_TRIPLES, LP_STEPS, LP_RANKED = 1024, 8, 16
LP_METRICS = ["mr", "mrr", "hits@1", "hits@3", "hits@10"]

# [clqa]: UltraQuery zero-shot on the repo's BetaE-format query dataset
# (query-datasets-synth-held/FB15k-237-betae: 4,000 entities, 120 relations
# with inverses, 76,800 training triples as the message graph, 1,400 valid
# and 1,400 test queries of 14 types), as
# config/ultraquery/transductive_synth.yaml runs it (batch 8, threshold 0.8,
# product logic, ultra_3g widths). The card's filtered ranks of the first
# CLQA_RANKED test queries of each type are held against the CPU's; an
# answer's probability on the card within CLQA_PROB_ATOL of the CPU's (12
# f32 layers a projection, up to 3 projections chained, sums in other
# orders; the threshold cuts no probability of these weights: all lie below
# 0.71), so a rank may move by the candidates within twice that of the
# answer. The HTTP server answers CLQA_HTTP_REQUESTS timed requests to each
# endpoint.
CLQA_ROOT = "query-datasets-synth-held"
CLQA_METRICS = ["mrr", "hits@1", "hits@3", "hits@10", "mape"]
CLQA_RANKED, CLQA_PROB_ATOL, CLQA_HTTP_REQUESTS = 8, 1e-4, 20

# [pretrain]: config/transductive/pretrain_synth.yaml, the mixture of the
# repo's three rule-KGs PRETRAIN_MEMBERS (kg-datasets/: 2,906, 3,732 and
# 2,070 entities; 136,778, 181,496 and 85,864 message edges; 72, 54 and 90
# relations with inverses) at ultra_3g width, batch PRETRAIN_BATCH, 128
# strict negatives, fast_test 300 as shipped, run through
# scripts/torch_pretrain.py's function with --epochs 1 --bpe PRETRAIN_STEPS;
# then PRETRAIN_WARM warm and PRETRAIN_TIMED timed steps on each member, and
# one step of the smallest member held against the CPU.
PRETRAIN_MEMBERS = [
    {"class": "SyntheticRuleKG", "num_nodes": 3000, "num_base_rel": 24, "num_comp_rel": 12,
     "num_base_triples": 24000, "seed": 0},
    {"class": "SyntheticRuleKG", "num_nodes": 4000, "num_base_rel": 18, "num_comp_rel": 9,
     "num_base_triples": 30000, "seed": 1},
    {"class": "SyntheticRuleKG", "num_nodes": 2200, "num_base_rel": 30, "num_comp_rel": 15,
     "num_base_triples": 18000, "seed": 2},
]
PRETRAIN_BATCH, PRETRAIN_NEGATIVE = 32, 128
PRETRAIN_STEPS, PRETRAIN_WARM, PRETRAIN_TIMED = 36, 2, 5

# [clqa-training]: config/ultraquery/transductive_synth.yaml with --epochs 1
# --bpe CLQA_TRAIN_STEPS on CLQA_ROOT's 640 training queries (batch 8,
# traversal dropout 0.25), through scripts/torch_run_query.py's function:
# per slot as shipped, and with grouped projections and grad_accum 2; then
# CLQA_TRAIN_WARM warm and CLQA_TRAIN_TIMED timed steps of each step kind
# (per slot; grouped; grouped with grad_accum 2), the first held against the
# CPU on the same plan; then pretrain_queries over a JointQueryDataset of
# CLQA_ROOT's set and one member written by data/synthetic_queries.py
# (QUERY_MIX_MEMBER), QUERY_MIX_STEPS steps, fast_test QUERY_MIX_FAST_TEST.
CLQA_TRAIN_STEPS, CLQA_TRAIN_WARM, CLQA_TRAIN_TIMED = 12, 2, 6
QUERY_MIX_MEMBER = dict(name="NELL-betae", num_nodes=2000, num_direct_rel=40,
                        num_triples=16000, queries_per_type=8, train_queries_per_type=32,
                        seed=1, categories=10)
QUERY_MIX_STEPS, QUERY_MIX_FAST_TEST = 8, 64


# [bf16]: compute_dtype bfloat16 (models/layers.py) on the card. The bf16
# rows of the kernels line: the bf16 instances of B1-B6 at the main path's
# shapes (BF16_TAGS: the name's mark and the launch key's instance), each
# held against its plain version in f64 on the same bf16 operands as the f32
# rows are and timed beside the f32 instance on the same values widened.
# Then ultra_3g served and fine-tuned, the PNA model served and stepped,
# attribution and a CLQA batch, each in bf16 against the same in f32 on the
# card, from the same seed-0 weights and inputs; and a bf16 conv on the card
# against the CPU. The bounds of bf16 against f32, derived from bf16's 8-bit
# mantissa before the first run: rounding an operand to bf16 moves it by at
# most 2^-9 of itself, so a product of two rounded operands moves by 2^-8,
# and each conv's output by about 2^-8 of its scale; 12 layers (6 + 6) move a
# score by at most about BF16_REL = 12 * 2^-8 of the largest |score|, and the
# loss by as much of itself. A CLQA answer's logit passes up to 3 chained
# projections: 3 * BF16_REL of the largest |logit|. Gradients run back
# through the same layers and through ReLUs and layer norms at which a
# rounding can flip a sign or a max: each tensor's max|err| is held to
# BF16_GRAD_WORST of its largest entry and the median over the tensors (for
# attribution, over the layers) to BF16_REL. PNA's std takes the square root
# of a variance computed from bf16-rounded squares, and near EPS its
# derivative 1/(2 std) amplifies that rounding without bound: the PNA step's
# gradients against f32's are reported, not held. They are held instead
# against the same bf16 step on the plain versions (plain_rspmm), which
# round the operands as the kernels do: the gradients to the same two bounds
# (a bf16 gradient rounded to either side of an f32 sum moves by one unit in
# the last place), the loss to BF16_PNA_LOSS_RTOL. That std amplifies the
# order of the f32 sums too, and the plain versions add with atomics whose
# order changes from run to run: on an H100 their loss moved by 1.6e-5 of
# itself between two runs while the kernels' was equal bit for bit (PERF.md),
# past the f32 steps' LOSS_RTOL; 1e-4 is GRAD_REL_TO_MAX's level. The conv
# on the card against the CPU, both in bf16, rounds the same operands the
# same way: the f32 tolerance (SCORE_RTOL, SCORE_ATOL).
BF16_TAGS = {torch.bfloat16: ("[bf16]", ("bf16_bf16",))}
BF16_REL, BF16_GRAD_WORST, BF16_PNA_LOSS_RTOL = 12 * 2.0**-8, MINMAX_GRAD_WORST, 1e-4
# the instance each wrapper launches on a bf16 model's path: the forwards,
# B4, B5 and B6 take bf16 relation and x rows, the input gradient (B1 on the
# source-major CSR) bf16 relation rows and the f32 output gradient, B2 bf16
# x rows
BF16_INSTANCES = {"rspmm_sum_fwd": "bf16_bf16", "rspmm_sum_dx": "bf16_f32",
                  "rspmm_sum_drel": "bf16", "rspmm_minmax_fwd": "bf16_bf16",
                  "rspmm_minmax_dx": "bf16_bf16", "rspmm_minmax_drel": "bf16_bf16",
                  "rspmm_dw": "bf16_bf16"}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def dw_bound_ms(csr, edge_weight, relation, x, g, out=None):
    """Least time for one edge-weight gradient on these inputs: x, g, the
    saved output (min/max only), the relation rows and the CSR (16 bytes an
    edge, the weight included) read once, each at its own element size, d_w
    written once; 3 f32 operations per feature of each CSR edge for the sum
    (a runtime-masked edge gets its derivative too), 5 per feature of each
    live edge for min/max (the weighted message and its compare)."""
    feat = x.shape[1]
    nbytes = tensor_bytes(x, g, relation, edge_weight, *(() if out is None else (out,)))
    nbytes += 8 * csr.rowptr.numel() + 16 * csr.col.numel()
    flops = (3 * csr.col.numel() if out is None else 5 * live_edges(edge_weight, csr.eid)) * feat
    return bound_ms(nbytes, flops)


def drel_bound_ms(seg, edge_weight, x, g, mul="mul"):
    """Least time for one sum relation gradient on these inputs: x (mul
    only, at its element size), g and the segments (src, dst, eid and the
    weight of each edge) read once, d_rel written once, and 3 (mul) or 2
    (add) f32 operations per feature of each edge whose weight is not 0; the
    piece table is not counted, as for B1."""
    feat, num_edges = g.shape[1], seg.src.numel()
    nbytes = tensor_bytes(*((x,) if mul == "mul" else ()), g) + 4 * seg.num_types * feat
    nbytes += 16 * num_edges
    return bound_ms(nbytes, (3 if mul == "mul" else 2) * live_edges(edge_weight, seg.eid) * feat)


def minmax_dx_bound_ms(csr_src, edge_weight, relation, x, g):
    """Least time for one min/max input gradient on these inputs: x, g, the
    saved output (g's shape), the relation rows and the CSR read once (x and
    the relation rows at their element size), the f32 d_x written once, and
    6 f32 operations per feature of each edge whose weight is not 0 (the
    message, its compare, the routed product and the sum)."""
    nbytes = tensor_bytes(x, relation) + 4 * (x.numel() + 2 * g.numel())
    nbytes += 8 * csr_src.rowptr.numel() + 16 * csr_src.col.numel()
    return bound_ms(nbytes, 6 * live_edges(edge_weight, csr_src.eid) * x.shape[1])


def minmax_drel_bound_ms(seg, edge_weight, relation, x, g):
    """Least time for one min/max relation gradient on these inputs: x, g,
    the saved output (g's shape), the relation rows and the segments (src,
    dst, eid and the weight of each edge) read once (x and the relation rows
    at their element size), the f32 d_rel written once, and 6 f32 operations
    per feature of each edge whose weight is not 0; the piece table and the
    partial rows are not counted, as for B2."""
    nbytes = tensor_bytes(x, relation) + 4 * (2 * g.numel() + relation.numel())
    nbytes += 16 * seg.src.numel()
    return bound_ms(nbytes, 6 * live_edges(edge_weight, seg.eid) * g.shape[1])


def kernel_row(name, source, replaces, launch_key, ms, plain_ms, bound, max_abs_err,
               tolerance, on_path=True, **extra):
    """One entry of the kernels line; ``launches`` is filled in at the end
    from the main path's counts at ``launch_key``."""
    least_ms, bound_by = bound
    f32 = "".join(f" {k}={extra[k]!r}" for k in ("f32_ms", "f32_ratio", "f32_equal")
                  if k in extra)
    print(f"[kernel] {name}: ms={ms!r} plain_ms={plain_ms!r} bound_ms={least_ms!r} "
          f"({bound_by}){f32}", flush=True)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": least_ms, "bound_by": bound_by,
            "library_ms": None,  # unless ``extra`` names the PyTorch call that computes it
            "launch_key": list(launch_key), "on_path": on_path, "tolerance": tolerance,
            **extra}


def sum_kernel_error(got, plain, layout, weight, a, b, mul):
    """A sum kernel's output ``got`` against ``plain`` on the same inputs in
    f64, within KERNEL_REL_TO_ABS_SUM of the sum of the absolute terms
    (``plain`` on absolute inputs) plus KERNEL_ATOL: (max |err|, max |err|
    over the largest |output|, worst |err| over its tolerance, ok)."""
    w64, a64, b64 = weight.double(), a.double(), b.double()
    want = plain(layout, w64, a64, b64, mul)
    abs_sum = plain(layout, w64.abs(), a64.abs(), b64.abs(), mul)
    torch.cuda.synchronize()
    err = (got.double() - want).abs()
    within = float((err / (KERNEL_REL_TO_ABS_SUM * abs_sum + KERNEL_ATOL)).max())
    ok = bool(torch.isfinite(got).all()) and got.shape == want.shape and within <= 1
    rel = float(err.max() / want.abs().max().clamp_min(1e-30))
    return float(err.max()), rel, within, ok


def largest_difference(a, b):
    """max |a - b|, where equal values (the same infinities included) differ
    by 0."""
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def hold(name, source, timed, kernel, plain, layout, weight, a, b, bound):
    """``kernel(layout, weight, a, b, mul)`` against ``plain`` for mul and
    add (:func:`sum_kernel_error`); times both (``plain`` in f32, as the
    path would run it) for each ``mul`` of ``timed``, which maps it to the
    TPU kernel it replaces. Returns (rows of the kernels line, ok); the row
    of "add" is named ``name`` with ``_add`` after the wrapper's name and is
    not on the path (distmult). Each row's launch key is the one the wrapper
    counted for these inputs. Where ``a`` or ``b`` is bf16 (a bf16
    instance: B1's and B2's walk 8 features a thread), a row also gets
    ``f32_ms``, the f32 instance on the same values widened to f32,
    ``f32_ratio``, ms over it, and ``f32_equal``, max |bf16 instance - f32
    instance| on those values: 0 where the two add the same terms in the
    same order, as the 8-feature walk does (reported, not held: the
    tolerance is the plain version's)."""
    from ultra_tpu_torch.utils.benchlib import device_ms

    errs, ok = {}, True
    for mul in ("mul", "add"):
        before = collections.Counter(kernel.launches)
        got = kernel(layout, weight, a, b, mul)
        (key,) = kernel.launches - before
        errs[mul], rel, within, case_ok = sum_kernel_error(got, plain, layout, weight, a, b, mul)
        ok &= case_ok
        print(f"[kernel] {name} mul={mul} {tuple(got.shape)}: ok={case_ok} "
              f"max_abs_err={errs[mul]!r} max_rel_err={rel!r} "
              f"worst_err_over_tolerance={within!r}", flush=True)

    rows = []
    widened = {a.dtype, b.dtype} != {torch.float32}
    for mul, replaces in timed.items():
        wrapper, rest = name.split("/", 1)
        row_name = name if mul == "mul" else f"{wrapper}_{mul}/{rest}"
        extra = {"piece_len": layout.piece_len} if hasattr(layout, "piece_len") else {}
        ms = device_ms(lambda: kernel(layout, weight, a, b, mul))
        if widened:
            a32, b32 = a.float(), b.float()
            extra["f32_ms"] = device_ms(lambda: kernel(layout, weight, a32, b32, mul))
            extra["f32_ratio"] = ms / extra["f32_ms"]
            extra["f32_equal"] = largest_difference(kernel(layout, weight, a, b, mul),
                                                    kernel(layout, weight, a32, b32, mul))
        rows.append(kernel_row(
            row_name, source, replaces, key, ms,
            device_ms(lambda: plain(layout, weight, a, b, mul), samples=PLAIN_SAMPLES),
            bound(layout, weight, a, b, mul), errs[mul],
            f"|err| <= {KERNEL_REL_TO_ABS_SUM} * sum|terms| + {KERNEL_ATOL} against the "
            "plain version in f64", on_path=mul == "mul", mul=mul, **extra,
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


def minmax_inputs(r, n, feat, gen):
    """Relation rows (r, feat) and x (n, feat) on the card, tie-heavy (from
    {-3..3}, a quarter of x's rows 0) and normal: {"ties": (rel, x),
    "normal": (rel, x)}."""
    ties_x = torch.randint(-3, 4, (n, feat), generator=gen).float()
    ties_x[torch.rand(n, generator=gen) < 0.25] = 0.0
    return {"ties": (torch.randint(-3, 4, (r, feat), generator=gen).float().cuda(), ties_x.cuda()),
            "normal": (torch.randn(r, feat, generator=gen).cuda(),
                       torch.randn(n, feat, generator=gen).cuda())}


# B6's cases: (aggregation, inputs, mul, is_min); the sum on normal inputs
DW_CASES = [("sum", "normal", mul, None) for mul in ("mul", "add")] + [
    ("minmax", kind, mul, is_min) for kind in ("ties", "normal") for mul in ("mul", "add")
    for is_min in (False, True)]


def dw_error(got, csr, w, rel, x, g, mul, out, masked=None):
    """B6's output ``got`` against its plain version, which routes in f32 as
    the forward did and adds in f64 (every input in f64 for the sum), within
    KERNEL_REL_TO_ABS_SUM of the sum of the absolute terms plus KERNEL_ATOL,
    and, where given, the eids ``masked`` at run time: the sum's derivative,
    0 for min/max. Returns (max |err|, worst |err| over its tolerance, ok, routed
    terms)."""
    from ultra_tpu_torch.ops.rspmm_cuda import rspmm_dw_terms

    if out is None:  # every input in f64
        terms = rspmm_dw_terms(csr, w.double(), rel.double(), x.double(), g.double(), mul)
    else:
        terms = rspmm_dw_terms(csr, w, rel, x, g.double(), mul, out)
    eid = csr.eid.long()
    want = torch.zeros(w.shape, dtype=torch.float64, device=w.device)
    abs_sum = want.clone().index_put_((eid,), terms.abs().sum(1))
    want.index_put_((eid,), terms.sum(1))
    routed = int((terms != 0).sum())
    del terms
    torch.cuda.synchronize()
    err = (got.double() - want).abs()
    within = float((err / (KERNEL_REL_TO_ABS_SUM * abs_sum + KERNEL_ATOL)).max())
    ok = bool(torch.isfinite(got).all()) and within <= 1
    if masked is not None:
        ok &= bool((got[masked] != 0).any() if out is None else (got[masked] == 0).all())
    return float(err.max()), within, ok, routed


def dw_slots_written(g_, rel, x, g):
    """B6 (the sum) over ``g_``'s CSR into a d_w filled with NaN where the
    wrapper zeroes it: (CSR edges whose slot was not written, slots not in
    the CSR that were written); both 0 when the walk writes the CSR's edges
    and nothing else."""
    from ultra_tpu_torch.ops import build, rspmm_cuda

    csr, w = g_.csr, g_.edge_weight
    d_w = torch.full(w.shape, float("nan"), device=w.device)
    rspmm_cuda.launch_dw(build.bind("rspmm_dw"), csr, w, rel, x, g, "mul", None, d_w)
    in_csr = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    in_csr[csr.eid.long()] = True
    return int(d_w[in_csr].isnan().sum()), int((~d_w[~in_csr].isnan()).sum())


def minmax_grad_error(got, terms_fn, layout, w, rel, x, g, out, mul, rows):
    """A min/max gradient kernel's output ``got`` (B4 or B5) against its
    plain version, which routes in f32 as the forward did and adds in f64
    (``terms_fn``: ``rspmm_minmax_dx_terms`` or ``rspmm_minmax_drel_terms``),
    within KERNEL_REL_TO_ABS_SUM of the sum of the absolute terms plus
    KERNEL_ATOL: (max |err|, worst |err| over its tolerance, ok, routed
    terms)."""
    index, terms = terms_fn(layout, w, rel, x, g.double(), out, mul)
    routed = int((terms != 0).sum())
    want = torch.zeros(rows, g.shape[1], dtype=torch.float64, device=g.device)
    abs_sum = torch.zeros_like(want).index_add_(0, index, terms.abs())
    want.index_add_(0, index, terms)
    del index, terms
    torch.cuda.synchronize()
    err = (got.double() - want).abs()
    within = float((err / (KERNEL_REL_TO_ABS_SUM * abs_sum + KERNEL_ATOL)).max())
    ok = bool(torch.isfinite(got).all()) and got.shape == want.shape and within <= 1
    return float(err.max()), within, ok, routed


def hold_minmax(tag, g_, feat, gen, replaces, dtype=torch.float32):
    """B3, B4 and B5 against their plain versions on ``g_`` at ``feat``, on
    tie-heavy inputs (relation and x from {-3..3}, a quarter of x's rows 0)
    and on normal ones, for mul and add and for max and min, with weights
    from ``minmax_weights``. B3 must equal its f32 plain version value for
    value, the all-masked row's -inf/+inf included; B4 and B5, given B3's
    output, must match plain versions that route in f32 as the forward did
    and add in f64. Times the three (normal inputs, mul, max) beside their
    plain versions in f32. With ``dtype`` bf16 the relation and x rows are
    rounded to bf16 (their bf16 instances; rows named ``...[bf16]/...``,
    each with ``f32_ms``, the f32 instance on the same values widened,
    ``f32_ratio``, ms over it, and ``f32_equal``, max |bf16 instance - f32
    instance| on those values). ``f32_equal`` must be 0 for B3, B4 and B5,
    whose bf16 instances compute the f32 instance's values in its order.
    Returns ({row name: row}, ok)."""
    from ultra_tpu_torch.ops import rspmm_minmax_cuda as k
    from ultra_tpu_torch.utils.benchlib import device_ms

    w, masked_row = minmax_weights(g_, gen)
    n, r = g_.num_nodes, g_.num_relations
    inputs = {kind: tuple(t.to(dtype) for t in pair)
              for kind, pair in minmax_inputs(r, n, feat, gen).items()}
    kind_tag, key_tag = BF16_TAGS.get(dtype, ("", ()))
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
                    err, within, case_ok, routed = minmax_grad_error(
                        got, terms_fn, layout, w, rel, x, g, out, mul, rows)
                    ok &= case_ok
                    errs[grad] = max(errs[grad], err)
                    print(f"[kernel] rspmm_minmax_{grad} {case}: ok={case_ok} "
                          f"max_abs_err={err!r} worst_err_over_tolerance="
                          f"{within!r} routed_terms={routed}", flush=True)
    rel, x = inputs["normal"]
    out = k.rspmm_minmax_fwd(g_.csr, w, rel, x, "mul", False)
    grad_tol = (f"|err| <= {KERNEL_REL_TO_ABS_SUM} * sum|terms| + {KERNEL_ATOL} against the "
                "plain version routed in f32 and added in f64")
    calls = {
        "fwd": lambda rel, x: k.rspmm_minmax_fwd(g_.csr, w, rel, x, "mul", False),
        "dx": lambda rel, x: k.rspmm_minmax_dx(g_.csr_src, w, rel, x, g, out, "mul"),
        "drel": lambda rel, x: k.rspmm_minmax_drel(g_.segments, w, rel, x, g, out, "mul"),
    }
    rel32, x32 = rel.float(), x.float()
    ms, extra = {}, {}
    for name, call in calls.items():
        ms[name], extra[name] = device_ms(lambda: call(rel, x)), {}
        if kind_tag:
            f32_ms = device_ms(lambda: call(rel32, x32))
            equal = largest_difference(call(rel, x), call(rel32, x32))
            extra[name] = {"f32_ms": f32_ms, "f32_ratio": ms[name] / f32_ms, "f32_equal": equal}
            # the bf16 instances (the 8-feature walk) must give the f32
            # instance's values on the widened rows
            same_ok = equal == 0
            ok &= same_ok
            print(f"[kernel] rspmm_minmax_{name}{kind_tag} {tag} against the f32 instance: "
                  f"ok={same_ok} f32_equal={equal!r}", flush=True)
    rows = [
        kernel_row(
            f"rspmm_minmax_fwd{kind_tag}/{tag}/F{feat}",
            "ultra_tpu_torch/csrc/rspmm_minmax_fwd.cu", replaces["fwd"],
            tuple(out.shape) + key_tag, ms["fwd"],
            device_ms(lambda: k.rspmm_minmax_fwd_plain(g_.csr, w, rel, x, "mul", False),
                      samples=PLAIN_SAMPLES),
            rspmm_bound_ms(g_.csr, w, rel, x), errs["fwd"],
            "equal to the plain version in f32, value for value", on_path=tag == "entity",
            **extra["fwd"]),
        kernel_row(
            f"rspmm_minmax_dx{kind_tag}/{tag}/F{feat}",
            "ultra_tpu_torch/csrc/rspmm_minmax_dx.cu", replaces["dx"],
            tuple(x.shape) + key_tag, ms["dx"],
            device_ms(lambda: k.rspmm_minmax_dx_plain(g_.csr_src, w, rel, x, g, out, "mul"),
                      samples=PLAIN_SAMPLES),
            minmax_dx_bound_ms(g_.csr_src, w, rel, x, g), errs["dx"], grad_tol,
            on_path=tag == "entity", **extra["dx"]),
        kernel_row(
            f"rspmm_minmax_drel{kind_tag}/{tag}/F{feat}",
            "ultra_tpu_torch/csrc/rspmm_minmax_drel.cu", replaces["drel"],
            tuple(rel.shape) + key_tag, ms["drel"],
            device_ms(lambda: k.rspmm_minmax_drel_plain(g_.segments, w, rel, x, g, out, "mul"),
                      samples=PLAIN_SAMPLES),
            minmax_drel_bound_ms(g_.segments, w, rel, x, g), errs["drel"], grad_tol,
            on_path=tag == "entity", **extra["drel"]),
    ]
    return {row["name"]: row for row in rows}, ok


def hold_dw(g_, gen, tag="entity", feats=(64, 512), dtype=torch.float32):
    """B6 against its plain version on the entity graph ``g_`` (named
    ``tag``), at each of ``feats``: F=64 is an attribution call's width (one
    query of D=64), F=512 a batch's. With weights
    from ``minmax_weights`` (10% masked at run time, and every edge into one
    row): the sum's gradient for mul and add on normal inputs, and min/max's
    (given B3's output) for mul and add, min and max, on tie-heavy and
    normal inputs. The plain version routes in f32 as the forward did and
    adds in f64. Times the sum (mul) at each width and min/max (mul, max)
    at F=512 beside the plain version in f32. With ``dtype`` bf16 the
    relation and x rows are rounded to bf16, as in :func:`hold_minmax`: each
    case's output must also equal the f32 instance's on the same values
    widened (its 8-feature pass adds in the f32 instance's order at every
    F), and each timed row gets ``f32_ms``, ``f32_ratio`` and ``f32_equal``.
    Returns ({row name: row}, ok)."""
    from ultra_tpu_torch.ops import rspmm_cuda as k
    from ultra_tpu_torch.ops.rspmm_minmax_cuda import rspmm_minmax_fwd
    from ultra_tpu_torch.utils.benchlib import device_ms

    w, masked_row = minmax_weights(g_, gen)
    n, r, csr = g_.num_nodes, g_.num_relations, g_.csr
    masked = csr.eid[csr.rowptr[masked_row]:csr.rowptr[masked_row + 1]].long()
    ok, rows, tol = True, {}, (f"|err| <= {KERNEL_REL_TO_ABS_SUM} * sum|terms| + {KERNEL_ATOL} "
                               "against the plain version routed in f32 and added in f64")
    replaces = "ultra_tpu/ops/rspmm_pallas.py:465"
    kind_tag, key_tag = BF16_TAGS.get(dtype, ("", ()))
    for feat in feats:
        inputs = {kind: tuple(t.to(dtype) for t in pair)
                  for kind, pair in minmax_inputs(r, n, feat, gen).items()}
        g = torch.randn(n, feat, generator=gen).cuda()
        errs = {"sum": 0.0, "minmax": 0.0}
        for agg, kind, mul, is_min in DW_CASES:
            rel, x = inputs[kind]
            out = None if agg == "sum" else rspmm_minmax_fwd(csr, w, rel, x, mul, is_min)
            got = k.rspmm_dw(csr, w, rel, x, g, mul, out)
            err, within, case_ok, routed = dw_error(got, csr, w, rel, x, g, mul, out, masked)
            same = ""
            if kind_tag:
                equal = largest_difference(got, k.rspmm_dw(csr, w, rel.float(), x.float(), g,
                                                           mul, out))
                case_ok &= equal == 0
                same = f" f32_equal={equal!r}"
            ok &= case_ok
            errs[agg] = max(errs[agg], err)
            name = "sum" if agg == "sum" else ("min" if is_min else "max")
            print(f"[kernel] rspmm_dw{kind_tag} {tag} F={feat} {kind} mul={mul} {name}: "
                  f"ok={case_ok} max_abs_err={err!r} worst_err_over_tolerance={within!r} "
                  f"routed_terms={routed}{same}", flush=True)
        rel, x = inputs["normal"]
        timed = [(f"rspmm_dw{kind_tag}/{tag}/F{feat}", None, feat == 64)]
        if feat == 512:
            timed.append((f"rspmm_dw_minmax{kind_tag}/{tag}/F{feat}",
                          rspmm_minmax_fwd(csr, w, rel, x, "mul", False), False))
        for name, out, on_path in timed:
            agg = "sum" if out is None else "minmax"
            rel32, x32 = rel.float(), x.float()
            ms = device_ms(lambda: k.rspmm_dw(csr, w, rel, x, g, "mul", out))
            extra = {}
            if kind_tag:
                extra["f32_ms"] = device_ms(lambda: k.rspmm_dw(csr, w, rel32, x32, g, "mul", out))
                extra["f32_ratio"] = ms / extra["f32_ms"]
                extra["f32_equal"] = largest_difference(
                    k.rspmm_dw(csr, w, rel, x, g, "mul", out),
                    k.rspmm_dw(csr, w, rel32, x32, g, "mul", out))
            rows[name] = kernel_row(
                name, "ultra_tpu_torch/csrc/rspmm_dw.cu", replaces, (n, feat) + key_tag, ms,
                device_ms(lambda: k.rspmm_dw_plain(csr, w, rel, x, g, "mul", out),
                          samples=PLAIN_SAMPLES),
                dw_bound_ms(csr, w, rel, x, g, out), errs[agg], tol, on_path=on_path,
                aggregate=agg, **extra)
    return rows, ok


def piece_checks(graph, uniform, rows, feat, dim, gen):
    """B1-B6 beside their layouts' piece tables (``graph.ROW_PIECE``,
    ``graph.segment_piece``), at ``feat`` (a batch's width) and ``dim``
    (attribution's):

    - the kernels-line rows of the entity graph's B1 forward at both
      widths, its d_x, B3 and B4 at ``feat`` and B6 at ``dim`` get
      ``uniform_ms``, the same launch on ``uniform`` (the graph's sources,
      types and edge count, uniformly drawn destinations) walking its
      destination-major CSR, whose rows are all short (for d_x and B4 it
      stands for the CSR by source of uniformly drawn sources; B4 routes
      against the forward of that transposed graph), and ``max_in_degree``
      (and ``uniform_max_in_degree``), the longest row the launch walks on
      each graph; the B5 rows get ``piece_len``, the segments' piece length
      (:func:`hold` gives it to the B2 rows);
    - B1 (mul and add, forward and d_x, both widths), B3 and B4 (min and
      max, mul and add, tie-heavy and normal inputs, ``feat``) and B6 (the
      sum and min/max as ``hold_dw`` holds them, at ``dim``, ``feat`` and
      DW_WIDE) against their plain versions on a graph whose rows have 0, 1,
      ROW_PIECE - 1, ROW_PIECE, ROW_PIECE + 1, 2 ROW_PIECE, 3,031 and 2
      ROW_PIECE edges, the last row's all masked at run time; its sources
      are a permutation of its destinations, so the CSR by source has the
      same rows. B1, B4 and B6 within their tolerances, B3 equal, the masked
      row -inf/+inf (B3), its edges' d_w 0 for min/max (B6);
    - B2 (mul and add) and B5 (min and max, mul and add, tie-heavy and
      normal inputs) at ``feat`` against their plain versions on segments
      whose types have 0, 1, L - 1, L, L + 1 and 3,031 edges, for each
      piece length L of the two graphs' segments;
    - two launches each of B1 (both widths), B4, B2 and B5 on ``graph``
      (B2 and B5 on its relation graph too) and B6 (the sum at ``dim``,
      min/max at ``feat``) give the same bits;
    - B6 on the boundary graph, padded and with edges dead at build time,
      into a d_w filled with NaN writes the slot of every CSR edge and no
      other.
    Returns ok."""
    from ultra_tpu_torch import graph as graph_module
    from ultra_tpu_torch.graph import build_segments, make_graph
    from ultra_tpu_torch.ops import rspmm_cuda as k
    from ultra_tpu_torch.ops import rspmm_minmax_cuda as mk
    from ultra_tpu_torch.utils.benchlib import device_ms

    rand = lambda *shape: torch.randn(*shape, generator=gen).cuda()
    longest = lambda csr: int(csr.rowptr.diff().max())
    w_u = uniform.edge_weight * (torch.rand(uniform.edge_weight.shape, generator=gen) >= 0.1).cuda()
    n, r = graph.num_nodes, graph.num_relations
    g_u = rand(n, feat)

    def minmax_dx_uniform(csr, w, rel, x, mul):
        out = mk.rspmm_minmax_fwd(uniform.csr_src, w, rel, x, mul)
        return lambda: mk.rspmm_minmax_dx(csr, w, rel, x, g_u, out, mul)

    def dw_uniform(csr, w, rel, x, mul):
        g = rand(n, x.shape[1])
        return lambda: k.rspmm_dw(csr, w, rel, x, g, mul)

    launch = lambda fn: lambda csr, w, rel, x, mul: lambda: fn(csr, w, rel, x, mul)
    for name, timed, walked in (
        (f"rspmm_sum_fwd/entity/F{feat}", launch(k.rspmm_sum_fwd), graph.csr),
        (f"rspmm_sum_fwd/entity/F{dim}", launch(k.rspmm_sum_fwd), graph.csr),
        (f"rspmm_sum_dx/entity/F{feat}", launch(k.rspmm_sum_dx), graph.csr_src),
        (f"rspmm_minmax_fwd/entity/F{feat}", launch(mk.rspmm_minmax_fwd), graph.csr),
        (f"rspmm_minmax_dx/entity/F{feat}", minmax_dx_uniform, graph.csr_src),
        (f"rspmm_dw/entity/F{dim}", dw_uniform, graph.csr),
    ):
        f = rows[name]["launch_key"][1]
        rel, x = rand(r, f), rand(n, f)
        rows[name].update(uniform_ms=device_ms(timed(uniform.csr, w_u, rel, x, "mul")),
                          max_in_degree=longest(walked),
                          uniform_max_in_degree=longest(uniform.csr))
        print(f"[kernel] {name}: ms={rows[name]['ms']!r} uniform_ms="
              f"{rows[name]['uniform_ms']!r} max_in_degree {longest(walked)} against "
              f"{longest(uniform.csr)}", flush=True)
    for name, row in rows.items():
        if name.startswith("rspmm_minmax_drel"):
            on = graph if "/entity/" in name else graph.relation_graph
            row["piece_len"] = on.segments.piece_len

    piece = graph_module.ROW_PIECE
    degrees = [0, 1, piece - 1, piece, piece + 1, 2 * piece, 3031, 2 * piece]
    masked_row, num_types = len(degrees) - 1, 7
    rng = np.random.default_rng(7)
    dst = np.repeat(np.arange(len(degrees)), degrees)
    edges = np.stack([dst, rng.permutation(dst)])
    g_ = make_graph(edges, rng.integers(0, num_types, dst.size), len(degrees), num_types,
                    device="cuda")
    w = g_.edge_weight.cpu() * torch.tensor([0.5, 1.0, 2.0])[
        torch.randint(0, 3, (dst.size,), generator=gen)]
    w[torch.rand(w.shape, generator=gen) < 0.1] = 0.0
    w[torch.from_numpy(dst == masked_row)] = 0.0
    w = w.cuda()
    ok = True
    for f in (dim, feat):
        rel, x = rand(num_types, f), rand(len(degrees), f)
        for name, fn, plain, csr in (
            ("rspmm_sum_fwd", k.rspmm_sum_fwd, k.rspmm_sum_fwd_plain, g_.csr),
            ("rspmm_sum_dx", k.rspmm_sum_dx, k.rspmm_sum_dx_plain, g_.csr_src),
        ):
            for mul in ("mul", "add"):
                err, _, within, case_ok = sum_kernel_error(fn(csr, w, rel, x, mul), plain, csr,
                                                           w, rel, x, mul)
                ok &= case_ok
                print(f"[kernel] {name} piece boundaries F={f} mul={mul}: ok={case_ok} "
                      f"max_abs_err={err!r} worst_err_over_tolerance={within!r}", flush=True)
    g_b = rand(len(degrees), feat)
    for kind, (rel, x) in minmax_inputs(num_types, len(degrees), feat, gen).items():
        for mul in ("mul", "add"):
            for is_min in (False, True):
                case = f"{kind} mul={mul} {'min' if is_min else 'max'}"
                got = mk.rspmm_minmax_fwd(g_.csr, w, rel, x, mul, is_min)
                want = mk.rspmm_minmax_fwd_plain(g_.csr, w, rel, x, mul, is_min)
                differ = int((got != want).sum())
                case_ok = differ == 0 and bool(torch.isinf(got[masked_row]).all())
                ok &= case_ok
                print(f"[kernel] rspmm_minmax_fwd piece boundaries {case}: ok={case_ok} "
                      f"differing={differ}", flush=True)
                d_x = mk.rspmm_minmax_dx(g_.csr_src, w, rel, x, g_b, got, mul)
                err, within, case_ok, routed = minmax_grad_error(
                    d_x, mk.rspmm_minmax_dx_terms, g_.csr_src, w, rel, x, g_b, got, mul,
                    len(degrees))
                ok &= case_ok
                print(f"[kernel] rspmm_minmax_dx piece boundaries {case}: ok={case_ok} "
                      f"max_abs_err={err!r} worst_err_over_tolerance={within!r} "
                      f"routed_terms={routed}", flush=True)
    masked = g_.csr.eid[g_.csr.rowptr[masked_row]:g_.csr.rowptr[masked_row + 1]].long()
    for f in (dim, feat, DW_WIDE):
        inputs, g_f = minmax_inputs(num_types, len(degrees), f, gen), rand(len(degrees), f)
        for agg, kind, mul, is_min in DW_CASES:
            rel, x = inputs[kind]
            out = None if agg == "sum" else mk.rspmm_minmax_fwd(g_.csr, w, rel, x, mul, is_min)
            err, within, case_ok, routed = dw_error(k.rspmm_dw(g_.csr, w, rel, x, g_f, mul, out),
                                                    g_.csr, w, rel, x, g_f, mul, out, masked)
            ok &= case_ok
            name = "sum" if agg == "sum" else ("min" if is_min else "max")
            print(f"[kernel] rspmm_dw piece boundaries F={f} {kind} mul={mul} {name}: "
                  f"ok={case_ok} max_abs_err={err!r} worst_err_over_tolerance={within!r} "
                  f"routed_terms={routed}", flush=True)

    for length in sorted({graph.segments.piece_len, graph.relation_graph.segments.piece_len}):
        counts = [0, 1, length - 1, length, length + 1, 3031]
        etype = np.repeat(np.arange(len(counts)), counts)
        nodes = 64
        edges = rng.integers(0, nodes, (2, etype.size))
        seg_graph = make_graph(edges, etype, nodes, len(counts), device="cuda")
        seg = build_segments(seg_graph.csr, len(counts), piece_len=length)
        w_s = (seg_graph.edge_weight.cpu() * (torch.rand(etype.size, generator=gen) >= 0.1)).cuda()
        x, g = rand(nodes, feat), rand(nodes, feat)
        for mul in ("mul", "add"):
            err, _, within, case_ok = sum_kernel_error(
                k.rspmm_sum_drel(seg, w_s, x, g, mul), k.rspmm_sum_drel_plain, seg, w_s, x, g,
                mul)
            ok &= case_ok
            print(f"[kernel] rspmm_sum_drel piece boundaries L={length} mul={mul}: "
                  f"ok={case_ok} max_abs_err={err!r} worst_err_over_tolerance={within!r} "
                  f"long_types={seg.long_rows.numel()} slots={seg.num_slots}", flush=True)
        w_m = (seg_graph.edge_weight.cpu() * torch.tensor([0.5, 1.0, 2.0])[
            torch.randint(0, 3, (etype.size,), generator=gen)]
            * (torch.rand(etype.size, generator=gen) >= 0.1)).cuda()
        for kind, (rel, x) in minmax_inputs(len(counts), nodes, feat, gen).items():
            for mul in ("mul", "add"):
                for is_min in (False, True):
                    case = f"L={length} {kind} mul={mul} {'min' if is_min else 'max'}"
                    out = mk.rspmm_minmax_fwd(seg_graph.csr, w_m, rel, x, mul, is_min)
                    err, within, case_ok, routed = minmax_grad_error(
                        mk.rspmm_minmax_drel(seg, w_m, rel, x, g, out, mul),
                        mk.rspmm_minmax_drel_terms, seg, w_m, rel, x, g, out, mul, len(counts))
                    ok &= case_ok
                    print(f"[kernel] rspmm_minmax_drel piece boundaries {case}: ok={case_ok} "
                          f"max_abs_err={err!r} worst_err_over_tolerance={within!r} "
                          f"routed_terms={routed}", flush=True)

    for f in (feat, dim):
        rel, x = rand(r, f), rand(n, f)
        w_g = graph.edge_weight
        same = torch.equal(k.rspmm_sum_fwd(graph.csr, w_g, rel, x),
                           k.rspmm_sum_fwd(graph.csr, w_g, rel, x))
        ok &= same
        print(f"[kernel] rspmm_sum_fwd/entity/F{f} two launches bitwise equal: {same}",
              flush=True)
    rel, x, g = rand(r, feat), rand(n, feat), rand(n, feat)
    w_g = graph.edge_weight
    out = mk.rspmm_minmax_fwd(graph.csr, w_g, rel, x)
    twice = {f"rspmm_minmax_dx/entity/F{feat}":
             lambda: mk.rspmm_minmax_dx(graph.csr_src, w_g, rel, x, g, out)}
    for tag, on in (("entity", graph), ("relation", graph.relation_graph)):
        x_r, g_r = rand(on.num_nodes, feat), rand(on.num_nodes, feat)
        rel_r = rand(on.num_relations, feat)
        out_r = mk.rspmm_minmax_fwd(on.csr, on.edge_weight, rel_r, x_r)
        twice[f"rspmm_sum_drel/{tag}/F{feat}"] = (
            lambda on=on, x_r=x_r, g_r=g_r: k.rspmm_sum_drel(on.segments, on.edge_weight, x_r,
                                                             g_r))
        twice[f"rspmm_minmax_drel/{tag}/F{feat}"] = (
            lambda on=on, x_r=x_r, g_r=g_r, rel_r=rel_r, out_r=out_r: mk.rspmm_minmax_drel(
                on.segments, on.edge_weight, rel_r, x_r, g_r, out_r))
    rel_d, x_d, g_d = rand(r, dim), rand(n, dim), rand(n, dim)
    twice[f"rspmm_dw/entity/F{dim}"] = lambda: k.rspmm_dw(graph.csr, w_g, rel_d, x_d, g_d)
    twice[f"rspmm_dw_minmax/entity/F{feat}"] = lambda: k.rspmm_dw(graph.csr, w_g, rel, x, g,
                                                                  "mul", out)
    for name, fn in twice.items():
        same = torch.equal(fn(), fn())
        ok &= same
        print(f"[kernel] {name} two launches bitwise equal: {same}", flush=True)
    # B6 on the boundary graph with edges dead at build time and padding,
    # neither in the CSR: it writes every CSR edge's slot and no other
    ew = np.where(rng.random(dst.size) < 0.1, 0.0, 1.0)
    g_pad = make_graph(g_.edge_index.cpu().numpy(), g_.edge_type.cpu().numpy(), len(degrees),
                       num_types, edge_weight=ew, pad_to=dst.size + 64, device="cuda")
    unwritten, stray = dw_slots_written(g_pad, rand(num_types, dim), rand(len(degrees), dim),
                                        rand(len(degrees), dim))
    ok &= unwritten == 0 and stray == 0
    print(f"[kernel] rspmm_dw piece boundaries: CSR slots unwritten {unwritten}, other slots "
          f"written {stray} (of {g_pad.num_edges_padded - g_pad.csr.col.numel()})", flush=True)
    return ok


def epilogue_rows(dim):
    """E1 (``ops/epilogue_cuda.py``) at each of EPILOGUE_SHAPES, N = ``dim``,
    with ReLU and the short cut, against its plain twin on the card
    (EPILOGUE_REL_TOL); times the kernel (writing over its input, as the
    conv has it), the twin and, as ``library_ms``, the composed PyTorch ops
    the conv ran before it. Its bound: y and the residual read and the
    output written once, 12 bytes an element, against 8 f32 operations an
    element. Returns (rows of the kernels line, ok)."""
    import torch.nn.functional as F

    from ultra_tpu_torch.ops.epilogue_cuda import conv_epilogue, conv_epilogue_plain
    from ultra_tpu_torch.utils.benchlib import device_ms

    gen = torch.Generator("cuda").manual_seed(0)
    rows, ok = {}, True
    for tag, m, on_path in EPILOGUE_SHAPES:
        y = 3 * torch.randn(m, dim, generator=gen, device="cuda") + 0.5
        res = torch.randn(m, dim, generator=gen, device="cuda")
        gamma = torch.rand(dim, generator=gen, device="cuda") + 0.5
        beta = torch.randn(dim, generator=gen, device="cuda")
        want = conv_epilogue_plain(y, gamma, beta, 1e-5, True, res)
        before = collections.Counter(conv_epilogue.launches)
        got = conv_epilogue(y.clone(), gamma, beta, 1e-5, True, res)
        (key,) = conv_epilogue.launches - before
        torch.cuda.synchronize()
        err = largest_difference(got, want)
        scale = float(want.abs().max())
        case_ok = bool(torch.isfinite(got).all()) and err <= EPILOGUE_REL_TOL * scale
        ok &= case_ok
        print(f"[kernel] conv_epilogue/{tag} ({m}, {dim}): ok={case_ok} max_abs_err={err!r} "
              f"over the largest |output| {err / scale!r}", flush=True)
        del got, want
        work = y.clone()
        ms = device_ms(lambda: conv_epilogue(work, gamma, beta, 1e-5, True, res))
        name = f"conv_epilogue/{tag}/M{m}"
        rows[name] = kernel_row(
            name, "ultra_tpu_torch/csrc/conv_epilogue.cu",
            "none: XLA's layer norm, ReLU and add (ultra_tpu/models/layers.py:122)", key, ms,
            device_ms(lambda: conv_epilogue_plain(y, gamma, beta, 1e-5, True, res),
                      samples=PLAIN_SAMPLES),
            bound_ms(12 * m * dim, 8 * m * dim), err,
            f"|err| <= {EPILOGUE_REL_TOL} * max |output| against the plain twin on the card",
            on_path=on_path,
            library_ms=device_ms(lambda: F.relu(F.layer_norm(y, (dim,), gamma, beta, 1e-5))
                                 + res, samples=PLAIN_SAMPLES),
            library_call="F.relu(F.layer_norm(y)) + residual")
        del y, res, work
        torch.cuda.empty_cache()
    return rows, ok


def conv_tail_rows(dim):
    """E2 (``ops/conv_tail_cuda.py``) at each of CONV_TAIL_SHAPES, and its
    bf16-x instance at CONV_TAIL_BF16_X_SHAPES, ReLU and the short cut,
    against its plain twin on the card (CONV_TAIL_REL_TOL), each check one
    launch (asserted); times the kernel, the twin and, as ``library_ms``,
    the ops the conv ran before it: ``torch.cat``, ``F.linear`` and E1 (for
    the bf16-x instance, ``x`` rounded and widened first, and ``f32_ms``,
    the f32 instance on the same operands). Its bound: x and u read and the
    output written once, 12 bytes an element, against 2 * 128 * 64 f32
    operations a row. Returns (rows of the kernels line, ok)."""
    import torch.nn.functional as F

    from ultra_tpu_torch.ops.conv_tail_cuda import conv_tail, conv_tail_plain
    from ultra_tpu_torch.ops.epilogue_cuda import conv_epilogue
    from ultra_tpu_torch.utils.benchlib import device_ms

    gen = torch.Generator("cuda").manual_seed(0)
    rows, ok = {}, True
    cases = ([(tag, m, on_path, False) for tag, m, on_path in CONV_TAIL_SHAPES]
             + [(f"{tag}-bf16_x", m, on_path, True)
                for tag, m, on_path in CONV_TAIL_BF16_X_SHAPES])
    for tag, m, on_path, round_x in cases:
        x = torch.randn(m, dim, generator=gen, device="cuda")
        u = 4 * torch.randn(m, dim, generator=gen, device="cuda") + 0.5
        w = (torch.rand(dim, 2 * dim, generator=gen, device="cuda") - 0.5) / 4
        b = torch.randn(dim, generator=gen, device="cuda") / 4
        gamma = torch.rand(dim, generator=gen, device="cuda") + 0.5
        beta = torch.randn(dim, generator=gen, device="cuda")
        args = (x, u, w, b, gamma, beta, 1e-5, True, x)
        want = conv_tail_plain(*args, round_x=round_x)
        before = collections.Counter(conv_tail.launches)
        got = conv_tail(*args, round_x=round_x)
        launched = conv_tail.launches - before
        torch.cuda.synchronize()
        err = largest_difference(got, want)
        scale = float(want.abs().max())
        key = (m, dim, "bf16_x") if round_x else (m, dim)
        case_ok = (bool(torch.isfinite(got).all()) and err <= CONV_TAIL_REL_TOL * scale
                   and launched == {key: 1})
        ok &= case_ok
        print(f"[kernel] conv_tail/{tag} ({m}, {dim}): ok={case_ok} launches={dict(launched)} "
              f"max_abs_err={err!r} over the largest |output| {err / scale!r}", flush=True)
        del got, want
        name = f"conv_tail/{tag}/M{m}"
        lin_x = x.bfloat16().float() if round_x else x
        extra = {}
        if round_x:
            extra["f32_ms"] = device_ms(lambda: conv_tail(*args))
        rows[name] = kernel_row(
            name, "ultra_tpu_torch/csrc/conv_tail.cu",
            "none: XLA's concatenation, linear, layer norm, ReLU and add "
            "(ultra_tpu/models/layers.py)", key,
            device_ms(lambda: conv_tail(*args, round_x=round_x)),
            device_ms(lambda: conv_tail_plain(*args, round_x=round_x), samples=PLAIN_SAMPLES),
            bound_ms(12 * m * dim, 2 * 2 * dim * dim * m), err,
            f"|err| <= {CONV_TAIL_REL_TOL} * max |output| against the plain twin on the card",
            on_path=on_path,
            library_ms=device_ms(lambda: conv_epilogue(
                F.linear(torch.cat([lin_x, u], dim=-1), w, b), gamma, beta, 1e-5, True, x),
                samples=PLAIN_SAMPLES),
            library_call="torch.cat + F.linear + E1 (conv_epilogue)", **extra)
        if round_x:
            rows[name]["f32_ratio"] = rows[name]["ms"] / extra["f32_ms"]
        del x, u, args, lin_x
        torch.cuda.empty_cache()
    return rows, ok


def scorer_rows():
    """S1 (``ops/mlp_score_cuda.py``) at each of SCORER_SHAPES against its
    plain twin on the card (SCORER_REL_TOL), each check one launch
    (asserted); times the kernel and, as ``plain_ms`` and ``library_ms``,
    the twin, which is the composed ops the scorer ran before it
    (``torch.cat``, ``F.linear``, ReLU, ``F.linear``). Its bound: a row of h
    read and its logit written, 260 bytes, against 2 * 64 * 128 + 2 * 128
    f32 operations a row. Prints the blocks an SM holds at each batch
    (ptxas's registers are on the ``[build]`` line). Returns (rows of the
    kernels line, ok)."""
    from ultra_tpu_torch.ops.mlp_score_cuda import blocks, mlp_score, mlp_score_plain
    from ultra_tpu_torch.utils.benchlib import device_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda").manual_seed(0)
    rows, ok = {}, True
    for tag, v, b, on_path in SCORER_SHAPES:
        h = (torch.relu(torch.randn(v, b, 64, generator=gen, device="cuda"))
             + 0.5 * torch.randn(v, b, 64, generator=gen, device="cuda"))
        q = torch.randn(b, 64, generator=gen, device="cuda")
        w1 = (torch.rand(128, 128, generator=gen, device="cuda") - 0.5) / 8
        b1 = torch.randn(128, generator=gen, device="cuda") / 8
        w2 = (torch.rand(1, 128, generator=gen, device="cuda") - 0.5) / 8
        b2 = torch.randn(1, generator=gen, device="cuda")
        args = (h, q, w1, b1, w2, b2)
        m = v * b
        want = mlp_score_plain(*args)
        before = collections.Counter(mlp_score.launches)
        got = mlp_score(*args)
        launched = mlp_score.launches - before
        torch.cuda.synchronize()
        err = largest_difference(got, want)
        scale = float(want.abs().max())
        grid = blocks(b, torch.device("cuda"))
        case_ok = (bool(torch.isfinite(got).all()) and err <= SCORER_REL_TOL * scale
                   and launched == {(m, b): 1} and grid > 0)
        ok &= case_ok
        print(f"[kernel] mlp_score/{tag} ({m}, {b}): ok={case_ok} launches={dict(launched)} "
              f"max_abs_err={err!r} over the largest |logit| {err / scale!r}; grid {grid} "
              f"blocks, {grid / sms!r} an SM", flush=True)
        del got, want
        name = f"mlp_score/{tag}/M{m}xB{b}"
        plain_ms = device_ms(lambda: mlp_score_plain(*args), samples=PLAIN_SAMPLES)
        rows[name] = kernel_row(
            name, "ultra_tpu_torch/csrc/mlp_score.cu",
            "none: XLA's concatenation, linears and ReLU (ultra_tpu/models/nbfnet.py)",
            (m, b), device_ms(lambda: mlp_score(*args)), plain_ms,
            bound_ms(260 * m, (2 * 64 * 128 + 2 * 128) * m), err,
            f"|err| <= {SCORER_REL_TOL} * max |logit| against the plain twin on the card",
            on_path=on_path, library_ms=plain_ms,
            library_call="torch.cat + F.linear + relu + F.linear (the plain twin)",
            blocks_per_sm=grid / sms)
        if on_path:
            rows[name]["phases"] = SCORER_PHASES
        if tag == "ranking":
            row = rows[name]
            fast = (row["ms"] <= SCORER_RANKING_MS
                    and row["ms"] <= SCORER_RANKING_RATIO * row["library_ms"])
            print(f"[kernel] mlp_score/ranking: {row['ms']!r} ms, "
                  f"{row['ms'] / row['library_ms']!r} of the composed ops' "
                  f"{row['library_ms']!r}; want at most {SCORER_RANKING_MS} ms and "
                  f"{SCORER_RANKING_RATIO:.3f}: ok={fast}", flush=True)
            ok &= fast
        del h, q, args
        torch.cuda.empty_cache()
    return rows, ok


def check_kernels(graph, rule_graph, lp_graph, clqa_graph, cfg, gen, uniform,
                  training_graphs=()):
    """Every kernel wrapper against its plain version at each shape the
    serving, training, validation and attribution paths give it: F = 512
    (a batch of 8, D = 64) for training and serving, 1024 for validation's
    two directions on the entity graph, 4096 for the precompute's 64
    relations on the relation graph, 64 (one query) for attribution's
    forwards on both graphs and its input and edge-weight gradients on the
    entity graph, on ``graph``; on ``rule_graph`` (the rule-KG that
    ``[visualize]`` explains a prediction on, and the training graph of
    ``[link-prediction]``) F = 64 for attribution and F = 512 for
    fine-tuning; on ``lp_graph`` (``[link-prediction]``'s inference graph)
    validation's F = 1024 and 4096; on ``clqa_graph`` (``[clqa]``'s query
    graph) F = 512 for a batch's projections and 4096 for the precompute;
    the sum kernels at the shapes of ``training_graphs`` (see
    :func:`training_shapes`: ``[pretrain]``'s members, ``[clqa-training]``'s
    query graph); then :func:`piece_checks` with
    ``uniform``, the graph with uniformly drawn destinations, and
    :func:`epilogue_rows`. Returns
    ({row name: row}, ok); a row's ``launch_key`` is the launch-count key of
    its launches."""
    from ultra_tpu_torch.ops import rspmm_cuda as k

    fwd_src, drel_src = (f"ultra_tpu_torch/csrc/{n}.cu" for n in KERNELS[:2])
    dim = cfg.entity_model.input_dim
    train_feat = BATCH * dim
    rows, ok = {}, True
    # the TPU kernels each launch site replaces: on the TPU the input gradient
    # is the forward kernel on the source plan (rspmm_pallas.py:1341-1374)
    # and the relation gradient the v2 or the v1 kernel (:1375-1392); the
    # min/max gradients run the v2 kernels with v2 plans, else the v1 ones
    # (rspmm_pallas.py:852-963). The rule-KG's graphs run attribution and
    # [link-prediction]'s fine-tuning, the inference graph validation, the
    # query graph [clqa]'s projections (the JAX package attaches the v2 plan
    # to a query graph and the v1 plan to its relation graph:
    # query/trainer.py:83-136).
    entity_fwd, relation_fwd = ("ultra_tpu/ops/rspmm_pallas_v2.py:508",
                                "ultra_tpu/ops/rspmm_pallas.py:283")
    for tag, g_, fwd_feats, dx_feats, drel_replaces, minmax_replaces, fwd_replaces in (
        ("entity", graph, (train_feat, 2 * train_feat, dim), (train_feat, dim),
         "ultra_tpu/ops/rspmm_pallas_v2.py:1054",
         {"fwd": "ultra_tpu/ops/rspmm_pallas_v2.py:704",
          "dx": "ultra_tpu/ops/rspmm_pallas_v2.py:927",
          "drel": "ultra_tpu/ops/rspmm_pallas_v2.py:982"}, entity_fwd),
        ("relation", graph.relation_graph, (train_feat, PRECOMPUTE_CHUNK * dim, dim),
         (train_feat,), "ultra_tpu/ops/rspmm_pallas.py:381",
         {"fwd": "ultra_tpu/ops/rspmm_pallas.py:574",
          "dx": "ultra_tpu/ops/rspmm_pallas.py:704",
          "drel": "ultra_tpu/ops/rspmm_pallas.py:745"}, relation_fwd),
        ("rulekg", rule_graph, (dim, train_feat), (dim, train_feat),
         "ultra_tpu/ops/rspmm_pallas_v2.py:1054", None, entity_fwd),
        ("rulekg-relation", rule_graph.relation_graph, (dim, train_feat), (train_feat,),
         "ultra_tpu/ops/rspmm_pallas.py:381", None, relation_fwd),
        ("inference", lp_graph, (2 * train_feat,), (), None, None, entity_fwd),
        ("inference-relation", lp_graph.relation_graph, (PRECOMPUTE_CHUNK * dim,), (), None,
         None, relation_fwd),
        ("query", clqa_graph, (train_feat,), (), None, None, entity_fwd),
        ("query-relation", clqa_graph.relation_graph, (PRECOMPUTE_CHUNK * dim,), (), None,
         None, relation_fwd),
    ):
        keep = torch.rand(g_.edge_weight.shape, generator=gen) >= 0.1
        w = (g_.edge_weight.cpu() * keep).cuda()
        rand = lambda *shape: torch.randn(*shape, generator=gen).cuda()
        cases = [
            (f"rspmm_sum_fwd/{tag}/F{feat}", fwd_src, {"mul": fwd_replaces}, k.rspmm_sum_fwd,
             k.rspmm_sum_fwd_plain, g_.csr, rand(g_.num_relations, feat),
             rand(g_.num_nodes, feat), rspmm_bound_ms)
            for feat in fwd_feats
        ] + [
            (f"rspmm_sum_dx/{tag}/F{feat}", fwd_src, {"mul": fwd_replaces},
             k.rspmm_sum_dx, k.rspmm_sum_dx_plain, g_.csr_src, rand(g_.num_relations, feat),
             rand(g_.num_nodes, feat), rspmm_bound_ms)
            for feat in dx_feats
        ]
        if drel_replaces:
            # B2 for add is _drel_add_kernel's function, off the path
            # (distmult) and timed for its row on the entity graph
            drel_timed = {"mul": drel_replaces}
            if tag == "entity":
                drel_timed["add"] = "ultra_tpu/ops/rspmm_pallas_v2.py:1022"
            cases.append(
                (f"rspmm_sum_drel/{tag}/F{train_feat}", drel_src, drel_timed,
                 k.rspmm_sum_drel, k.rspmm_sum_drel_plain, g_.segments,
                 rand(g_.num_nodes, train_feat), rand(g_.num_nodes, train_feat),
                 drel_bound_ms))
        for name, source, timed, kernel, plain, layout, a, b, bound in cases:
            case_rows, case_ok = hold(name, source, timed, kernel, plain, layout, w, a, b,
                                      bound)
            for row in case_rows:
                if tag in TAG_PHASES:
                    row["phases"] = TAG_PHASES[tag]
            rows.update((row["name"], row) for row in case_rows)
            ok &= case_ok
        if minmax_replaces:
            minmax_rows, minmax_ok = hold_minmax(tag, g_, train_feat, gen, minmax_replaces)
            rows.update(minmax_rows)
            ok &= minmax_ok
        torch.cuda.empty_cache()
    for tag, g_, fwd_feats, dx_feats, drel_feats, replaces, phases in training_graphs:
        keep = torch.rand(g_.edge_weight.shape, generator=gen) >= 0.1
        w = (g_.edge_weight.cpu() * keep).cuda()
        rand = lambda *shape: torch.randn(*shape, generator=gen).cuda()
        fwd_replaces, drel_replaces = replaces
        cases = (
            [(f"rspmm_sum_fwd/{tag}/F{f}", fwd_src, fwd_replaces, k.rspmm_sum_fwd,
              k.rspmm_sum_fwd_plain, g_.csr, rspmm_bound_ms) for f in fwd_feats]
            + [(f"rspmm_sum_dx/{tag}/F{f}", fwd_src, fwd_replaces, k.rspmm_sum_dx,
                k.rspmm_sum_dx_plain, g_.csr_src, rspmm_bound_ms) for f in dx_feats]
        )
        for name, source, replaces_, kernel, plain, layout, bound in cases:
            feat = int(name.rsplit("F", 1)[1])
            case_rows, case_ok = hold(name, source, {"mul": replaces_}, kernel, plain, layout,
                                      w, rand(g_.num_relations, feat),
                                      rand(g_.num_nodes, feat), bound)
            for row in case_rows:
                row["phases"] = phases
                rows[row["name"]] = row
            ok &= case_ok
        for feat in drel_feats:
            case_rows, case_ok = hold(
                f"rspmm_sum_drel/{tag}/F{feat}", drel_src, {"mul": drel_replaces},
                k.rspmm_sum_drel, k.rspmm_sum_drel_plain, g_.segments, w,
                rand(g_.num_nodes, feat), rand(g_.num_nodes, feat), drel_bound_ms)
            for row in case_rows:
                row["phases"] = phases
                rows[row["name"]] = row
            ok &= case_ok
        torch.cuda.empty_cache()
    for g_, tag, feats in ((graph, "entity", (dim, train_feat)), (rule_graph, "rulekg", (dim,))):
        dw_rows, dw_ok = hold_dw(g_, gen, tag, feats)
        rows.update(dw_rows)
        ok &= dw_ok
    t0 = time.perf_counter()
    ok &= piece_checks(graph, uniform, rows, train_feat, dim, gen)
    print(f"[kernel] piece checks (uniform graph, piece boundaries, determinism): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    epilogue, epilogue_ok = epilogue_rows(dim)
    rows.update(epilogue)
    return rows, ok and epilogue_ok


# rows whose launch keys (output shapes) other phases' graphs can share: a
# row counts the launches of these phases only (rows of other tags count
# every phase's). The rule-KG of [link-prediction]'s inference graph is also
# a [pretrain] member, and [pretrain]'s validation runs its graphs at
# [clqa]'s and [link-prediction]'s widths.
TAG_PHASES = {"inference": ("link-prediction", "tooling"),
              "inference-relation": ("link-prediction", "tooling"),
              "query": ("clqa", "clqa-training", "tooling"),
              "query-relation": ("clqa", "clqa-training", "tooling")}


def training_shapes(cfg, member_graphs, query_graph):
    """The training paths' sum-kernel shapes for :func:`check_kernels`:
    (tag, graph, forward widths, input-gradient widths, relation-gradient
    widths, (replaced forward, replaced relation gradient), phases). Each
    ``[pretrain]`` member's graph at a batch's F = PRETRAIN_BATCH * 64
    (forward, both gradients) and validation's widths (its entity graph at
    F = 2 * PRETRAIN_BATCH // 8 * 64, its relation graph at the
    precompute's); ``[clqa-training]``'s query graph at a batch's F = 512
    and a micro-batch's under grad_accum 2, 256 (the query graph's forward
    at 512 has its row from ``[clqa]``)."""
    dim = cfg.entity_model.input_dim
    feat, micro = BATCH * dim, BATCH // 2 * dim
    pre_feat = PRETRAIN_BATCH * dim
    valid_feat = 2 * max(PRETRAIN_BATCH // 8, 1) * dim
    entity = ("ultra_tpu/ops/rspmm_pallas_v2.py:508", "ultra_tpu/ops/rspmm_pallas_v2.py:1054")
    relation = ("ultra_tpu/ops/rspmm_pallas.py:283", "ultra_tpu/ops/rspmm_pallas.py:381")
    out = []
    for i, g_ in enumerate(member_graphs):
        out += [(f"member{i}", g_, (pre_feat, valid_feat), (pre_feat,), (pre_feat,), entity,
                 ("pretrain",)),
                (f"member{i}-relation", g_.relation_graph, (pre_feat, PRECOMPUTE_CHUNK * dim),
                 (pre_feat,), (pre_feat,), relation, ("pretrain",))]
    if query_graph is not None:
        out += [("query", query_graph, (micro,), (feat, micro), (feat, micro), entity,
                 TAG_PHASES["query"]),
                ("query-relation", query_graph.relation_graph, (feat, micro), (feat, micro),
                 (feat, micro), relation, TAG_PHASES["query"])]
    return out


def serve(split, ckpt, device):
    from ultra_tpu_torch.serve import UltraPredictor

    return UltraPredictor.from_checkpoint(str(ckpt), split, device=device,
                                          batch_size=BATCH)


# the kernels that end a conv layer (E1, E2) and the entity pass (S1, the
# scorer), whose launches are read apart (:func:`layer_ends`)
LAYER_ENDS = ("conv_epilogue", "conv_tail", "mlp_score")


def launch_counts():
    """{wrapper: {output shape (rows, F), for B2 (V, R, F), for the gathers
    with the element type: launches}} since the last reset; E1's, E2's and
    S1's are read apart (:func:`layer_ends`)."""
    from ultra_tpu_torch.ops import build

    return {name: dict(counter) for name, counter in build.launch_counters().items()
            if name not in LAYER_ENDS}


def layer_ends():
    """{E1's, E2's and S1's wrapper: {(rows, N), for S1 (rows, B):
    launches}} since the last reset."""
    from ultra_tpu_torch.ops import build

    counters = build.launch_counters()
    return {name: dict(counters[name]) for name in LAYER_ENDS}


def no_launches():
    """:func:`launch_counts` with no launch."""
    return {name: {} for name in launch_counts()}


def reset_launch_counts():
    from ultra_tpu_torch.ops import build

    build.clear_launch_counters()


def fwd_launches(counts):
    return sum(counts["rspmm_sum_fwd"].values())


def as_json(counts):
    return {name: {"x".join(map(str, key)): n for key, n in sorted(by_shape.items())}
            for name, by_shape in counts.items()}


def times(counts, n):
    return {name: {shape: n * c for shape, c in by_shape.items()}
            for name, by_shape in counts.items()}


def plus(a, b):
    out = {name: dict(by_shape) for name, by_shape in a.items()}
    for name, by_shape in b.items():
        for shape, c in by_shape.items():
            row = out.setdefault(name, {})
            row[shape] = row.get(shape, 0) + c
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
    counts = no_launches()
    n_sum, n_ext = rspmm_calls_per_layer(model_cfg.aggregate_func)
    layers = len(model_cfg.hidden_dims)
    add_launches(counts, "rspmm_sum_fwd", (num_rows, feat), n_sum * layers)
    add_launches(counts, "rspmm_minmax_fwd", (num_rows, feat), n_ext * layers)
    return counts


def per_step_launches(cfg, num_nodes, num_rel, batch=BATCH):
    """What autograd asks of the rspmm in one step of ``batch`` rows (one
    projection of a query step), by launch key (the output shape; B2's with
    the graph's nodes before it): a
    forward, a relation gradient and an input gradient of each rspmm call of
    every layer of both models, except the input gradients of the relation
    model's first layer, whose input is a constant boundary. The relation
    graph has ``num_rel`` nodes and 4 edge types; the entity graph
    ``num_nodes`` nodes and ``num_rel`` edge types."""
    feat = batch * cfg.entity_model.input_dim
    counts = plus(forward_launches(cfg.relation_model, num_rel, feat),
                  forward_launches(cfg.entity_model, num_nodes, feat))
    for model, rows, types, dx_layers in (
        (cfg.relation_model, num_rel, 4, len(cfg.relation_model.hidden_dims) - 1),
        (cfg.entity_model, num_nodes, num_rel, len(cfg.entity_model.hidden_dims)),
    ):
        n_sum, n_ext = rspmm_calls_per_layer(model.aggregate_func)
        layers = len(model.hidden_dims)
        add_launches(counts, "rspmm_sum_dx", (rows, feat), n_sum * dx_layers)
        add_launches(counts, "rspmm_sum_drel", (rows, types, feat), n_sum * layers)
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


def moved_by_one_ulp(model, seed=5):
    """A copy of ``model`` with each weight moved by one unit in the last
    place, up or down at random."""
    moved = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in moved.parameters():
            sign = torch.randint(0, 2, p.shape, generator=gen).float() * 2 - 1
            p.mul_(1 + sign.to(p.device) * 2.0**-23)
    return moved


def train_steps(split, graph, cfg, tag="training", check_batch=BATCH):
    """One step held against the same step on the CPU, the same step with
    TF32 matrix products as a control of that comparison, the same step on
    the card from weights moved by one unit in the last place (how far
    rounding alone moves the gradients), then WARM_STEPS warm and
    TIMED_STEPS timed steps on the card, each with its own sampled batch
    and easy-edge mask. The held step takes a batch of ``check_batch`` rows
    (the CPU's step costs in proportion to it), the others BATCH. Prints the
    ``[tag]`` record, then checks. Returns (whether the TF32 control passed
    the gradient check, the timed steps' launches)."""
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
    for i in range(1 + WARM_STEPS + TIMED_STEPS):
        pos = triples[rng.choice(len(triples), check_batch if i == 0 else BATCH, replace=False)]
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
    ulp_model = moved_by_one_ulp(ulp_model)
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
        "batch": BATCH, "check_batch": check_batch, "num_negative": NUM_NEGATIVE,
        "edges_masked_per_batch": masked,
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
    want_first = per_step_launches(cfg, graph.num_nodes, graph.num_relations, batch=check_batch)
    check(first_counts == want_first,
          f"one train step launched {first_counts}, want {want_first}")
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
    against the same predictor on the CPU. E2 ends each layer of the
    relation model's precompute, E1 each PNA layer of a batch (its linear
    takes 13 x 64), S1 scores each batch: one launch. Returns (the
    ``[pna-serving]`` record, the launches of the precompute and the 4
    batches, E1's, E2's and S1's among them)."""
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
    precompute_counts, precompute_ends = launch_counts(), layer_ends()

    rng = np.random.default_rng(2)
    h = rng.integers(0, num_nodes, TAIL_BATCHES * BATCH)
    r = rng.integers(0, num_rel // 2, TAIL_BATCHES * BATCH)
    t, r_head = rng.integers(0, num_nodes, BATCH), rng.integers(0, num_rel // 2, BATCH)
    reset_launch_counts()
    tail_s, _ = pred.predict_tails(h, r, k=TOPK)
    head_s, _ = pred.predict_heads(t, r_head, k=TOPK)
    serve_counts, serve_ends = launch_counts(), layer_ends()

    reset_launch_counts()
    lat = []
    t_all = time.perf_counter()
    for _ in range(TIMED_BATCHES):
        hb, rb = rng.integers(0, num_nodes, BATCH), rng.integers(0, num_rel // 2, BATCH)
        t0 = time.perf_counter()
        pred.predict_tails(hb, rb, k=TOPK)  # returns host arrays: synchronised
        lat.append(1e3 * (time.perf_counter() - t0))
    total_s = time.perf_counter() - t_all
    timed_counts, timed_ends = launch_counts(), layer_ends()
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
    relation_layers = len(cfg.relation_model.hidden_dims) * -(-num_rel // PRECOMPUTE_CHUNK)
    entity_layers = len(cfg.entity_model.hidden_dims)
    # E1 ends each PNA layer of a batch and S1 scores it: one launch a batch
    batch_ends = lambda batches: {
        "conv_epilogue": {(num_nodes * BATCH, dim): entity_layers * batches},
        "conv_tail": {}, "mlp_score": {(num_nodes * BATCH, BATCH): batches}}
    want_ends = ({"conv_epilogue": {},
                  "conv_tail": {(num_rel * PRECOMPUTE_CHUNK, dim): relation_layers},
                  "mlp_score": {}},
                 batch_ends(TAIL_BATCHES + HEAD_BATCHES), batch_ends(TIMED_BATCHES))
    record = {
        "params": n_params, "setup_s": setup_s,
        "batch_ms_median": statistics.median(lat), "batch_ms_min": min(lat),
        "batch_ms_max": max(lat), "requests_per_s": TIMED_BATCHES * BATCH / total_s,
        "peak_mem_mib": peak_mib, "cpu_vs_card_max_abs_err": float(score_err.max()),
        "cpu_s": cpu_s, "launches_per_batch": as_json(per_batch),
        "launches": {"precompute": as_json(precompute_counts), "serve": as_json(serve_counts),
                     "layer_ends": [as_json(precompute_ends), as_json(serve_ends),
                                    as_json(timed_ends)]},
    }
    print("[pna-serving] " + json.dumps(record), flush=True)
    check((precompute_ends, serve_ends, timed_ends) == want_ends,
          f"E1, E2 and S1 launched {precompute_ends} in the PNA precompute, {serve_ends} in "
          f"its 4 batches and {timed_ends} in the timed ones, want {want_ends}")
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
    counts = plus(precompute_counts, serve_counts)
    return record, plus(counts, plus(precompute_ends, serve_ends))


def conv_checks(graph, num_rel):
    """A ``max`` conv and a ``rotate`` conv (sum: B1 at twice the width) at
    F = 512 on the entity graph, on the card against the same conv on the
    CPU, forward, with random weights and inputs from a seed; each conv's
    launches are read around its card run (E2 ends each: one launch).
    Returns the ``[conv]`` record."""
    from ultra_tpu_torch.models.layers import ConvConfig, GeneralizedRelationalConv

    cpu_graph = graph.to("cpu")
    gen = torch.Generator().manual_seed(3)
    x, boundary = (torch.randn(graph.num_nodes, BATCH, 64, generator=gen) for _ in range(2))
    query = torch.randn(BATCH, 64, generator=gen)
    feat = BATCH * 64
    record, ok = {}, True
    tail = {"conv_tail": {(graph.num_nodes * BATCH, 64): 1}}
    for name, kw, want in (
        ("max", dict(aggregate_func="max"),
         {"rspmm_minmax_fwd": {(graph.num_nodes, feat): 1}, **tail}),
        ("rotate", dict(message_func="rotate"),
         {"rspmm_sum_fwd": {(graph.num_nodes, 2 * feat): 1}, **tail}),
    ):
        torch.manual_seed(0)
        conv = GeneralizedRelationalConv(ConvConfig(num_relation=num_rel, **kw))
        reset_launch_counts()
        with torch.no_grad():
            got = copy.deepcopy(conv).cuda()(graph, x.cuda(), boundary.cuda(), query.cuda())
            got = got.cpu()
            counts = {k: v for k, v in launch_counts().items() if v}
            counts.update({k: v for k, v in layer_ends().items() if v})
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


def boundary_rows_run(cfg, device="cuda"):
    """The boundary added as its rows (``models/layers.py``, ``_update``) at
    the ranking cell's entity pass, random weights from a seed: the
    relation model (on the 74 relations) and each of the entity model's six hidden
    states with ``boundary_rows`` given must equal the same
    ``bellmanford`` without them bit for bit, and the scores of
    ``entity_nbfnet_score_all`` the dense path's. Heads repeat across the
    batch. Then times the pass's six ``index_add_`` calls of 16 rows
    against its six dense adds of (V, 16, 64) (``benchlib.device_ms``).
    Returns the record."""
    from ultra_tpu_torch.data.kg import KGSplit, split_to_graph
    from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
    from ultra_tpu_torch.models.nbfnet import (
        Ultra, _score_nodes, bellmanford, boundary_rows, entity_nbfnet_score_all,
        rel_nbfnet_apply, scatter_boundary,
    )
    from ultra_tpu_torch.utils.benchlib import device_ms

    t0 = time.perf_counter()
    g = RANKING_GRAPH
    trip = random_kg_triples(g["num_nodes"], g["num_direct_rel"], g["num_triples"], seed=0,
                             rel_dist=g["rel_dist"], categories=g["categories"])
    edge_index, edge_type = with_inverses(trip, g["num_direct_rel"])
    graph = split_to_graph(KGSplit(edge_index, edge_type, g["num_nodes"],
                                   2 * g["num_direct_rel"], np.ascontiguousarray(trip[:, :2].T),
                                   trip[:, 2].copy()), device=device)
    setup_s = time.perf_counter() - t0
    torch.manual_seed(0)
    model = Ultra(cfg).to(device)
    gen = torch.Generator().manual_seed(7)
    b = RANKING_QUERIES
    h = torch.randint(0, graph.num_nodes, (b,), generator=gen)
    h[b // 2::3] = h[0]  # a head repeated across the batch
    h = h.to(device)
    r = torch.randint(0, graph.num_relations, (b,), generator=gen).to(device)
    record = {"V": graph.num_nodes, "E": int(graph.csr.col.numel()), "B": b,
              "graph_s": round(setup_s, 1)}
    with torch.no_grad():
        rel_repr = rel_nbfnet_apply(model.relation_model, graph.relation_graph, r)
        ones = torch.ones(b, cfg.relation_model.input_dim, device=device)
        dense_rel = bellmanford(model.relation_model, graph.relation_graph,
                                scatter_boundary(r, ones, graph.relation_graph.num_nodes),
                                ones)[-1].transpose(0, 1)
        record["relation_equal"] = torch.equal(rel_repr, dense_rel)
        query = rel_repr[torch.arange(b, device=device), r]
        boundary = scatter_boundary(h, query, graph.num_nodes)
        rows = boundary_rows(h, query, graph.num_nodes)
        got = bellmanford(model.entity_model, graph, boundary, query, rel_repr, rows)
        want = bellmanford(model.entity_model, graph, boundary, query, rel_repr)
        record["hiddens_equal"] = [torch.equal(a, w) for a, w in zip(got, want)]
        dense_scores = _score_nodes(model.entity_model, want, query)
        del got, want
        scores = entity_nbfnet_score_all(model.entity_model, graph, rel_repr, h, r)
        record["scores_equal"] = torch.equal(scores, dense_scores)
        del dense_scores, scores
        update = torch.randn(boundary.shape, generator=torch.Generator().manual_seed(1)).to(device)
        flat = update.view(-1, update.shape[-1])
        index, values = rows
        n_layers = len(cfg.entity_model.hidden_dims)

        def dense_adds():
            for _ in range(n_layers):
                update + boundary

        def row_adds():
            for _ in range(n_layers):
                flat.index_add_(0, index, values)

        record["dense_adds_ms"] = device_ms(dense_adds)
        record["index_adds_ms"] = device_ms(row_adds)
    record["ok"] = (record["relation_equal"] and all(record["hiddens_equal"])
                    and record["scores_equal"])
    print("[boundary-rows] " + json.dumps(record), flush=True)
    check(record["ok"], f"the boundary's rows differ from its dense add: {record}")
    return record


def attribution_launches(cfg, num_nodes, num_rel):
    """What one ``edge_gradients`` call of a sum model launches (one query,
    F = D): every layer's forward on both graphs; on the entity graph the
    edge-weight gradient of every layer and the input gradient of every
    layer but the first (whose input, the boundary, needs none); no
    relation gradient, since the parameters are frozen."""
    feat = cfg.entity_model.input_dim
    layers = len(cfg.entity_model.hidden_dims)
    counts = plus(forward_launches(cfg.relation_model, num_rel, feat),
                  forward_launches(cfg.entity_model, num_nodes, feat))
    add_launches(counts, "rspmm_sum_dx", (num_nodes, feat), layers - 1)
    add_launches(counts, "rspmm_dw", (num_nodes, feat), layers)
    return counts


def gradient_errors(got, want, live):
    """Per layer, max|err| over the live edges over that layer's largest
    |gradient| on the CPU."""
    return [float(np.abs(g[live] - w[live]).max() / max(np.abs(w[live]).max(), 1e-30))
            for g, w in zip(got, want)]


def gradient_offs(got, want, live):
    """Per layer, how many live edges' gradients differ by more than
    VIS_GRAD_REL_TO_MAX of that layer's largest |gradient| in ``want``."""
    return [int((np.abs(g[live] - w[live])
                 > VIS_GRAD_REL_TO_MAX * np.abs(w[live]).max()).sum())
            for g, w in zip(got, want)]


def contiguous(path, head, tail):
    return (path[0][0] == head and path[-1][1] == tail
            and all(a[1] == b[0] for a, b in zip(path[:-1], path[1:])))


def rule_kg(device):
    """The repo's rule-KG (SYNTHRULE), read from its cache, and its test
    split's graph on ``device``, built as ``visualize_from_config`` builds
    it. Returns (the dataset, the graph)."""
    from ultra_tpu_torch.data import kg
    from ultra_tpu_torch.train.runner import prepare_graph

    dataset = kg.build_dataset("SyntheticRuleKG", str(ROOT / "kg-datasets"), **SYNTHRULE).load()
    return dataset, prepare_graph(dataset.test, device=device)


def visualize_run(split, graph, cfg, rule_dataset):
    """Edge-importance attribution at full ``ultra_3g`` width (random weights
    from seed 0). On the card: ``edge_gradients`` for VIS_QUERIES target
    triples of the FB15k-237-shaped graph, each call's launches asserted,
    then the same calls with TF32 matrix products (a control that must fail
    the card-vs-CPU check); one call of the PNA model (max and min
    aggregation, which runs per edge in plain torch), its time, launches
    and peak memory read around it, and the same call with TF32 and from
    weights moved by one unit in the last place (VIS_MINMAX_EDGES_OFF); then
    ``visualize_from_config``, the function the command line runs once it
    has read its YAML, on the repo's rule-KG ``rule_dataset`` from a
    ``.pth``. Then the same calls on the CPU, each gradient and the
    explanation's top path held against the card's; and the command line
    itself, where PyYAML is installed. Returns (the ``[visualize]`` record,
    the launches of the card calls)."""
    from ultra_tpu_torch.models.visualize import (
        edge_gradients, format_paths, visualize_from_config,
    )
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.utils.benchlib import pna_config

    pna_cfg = pna_config()
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    pna_model = init_ultra_params(pna_cfg, torch.Generator().manual_seed(0), device="cuda")
    live = (graph.edge_weight != 0).cpu().numpy()
    rng = np.random.default_rng(4)
    picks = rng.choice(split.target_edge_index.shape[1], VIS_QUERIES, replace=False)
    queries = [(int(split.target_edge_index[0, i]), int(split.target_edge_index[1, i]),
                int(split.target_edge_type[i])) for i in picks]
    want_counts = attribution_launches(cfg, graph.num_nodes, split.num_relations)
    pna_want = forward_launches(pna_cfg.relation_model, split.num_relations,
                                pna_cfg.entity_model.input_dim)

    edge_gradients(model, graph, *queries[0])  # warm-up
    counts, card, lat = [], [], []
    for h, t, r in queries:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.append(edge_gradients(model, graph, h, t, r))  # copies to the host
        lat.append(1e3 * (time.perf_counter() - t0))
        counts.append(launch_counts())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = [edge_gradients(model, graph, h, t, r) for h, t, r in queries]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

    edge_gradients(pna_model, graph, *queries[0])  # warm-up
    torch.cuda.synchronize()
    resident_mib = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    pna_card = edge_gradients(pna_model, graph, *queries[0])
    pna_ms = 1e3 * (time.perf_counter() - t0)
    pna_counts = launch_counts()
    pna_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pna_tf32 = edge_gradients(pna_model, graph, *queries[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    pna_ulp = edge_gradients(moved_by_one_ulp(pna_model), graph, *queries[0])

    # the full visualize on the repo's rule-KG, from a .pth, as the command
    # line runs it
    ckpt = ROOT / "build" / "chip_smoke" / "ultra_3g_seed0_visualize.pth"
    torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
    cpu_model, pna_cpu_model = copy.deepcopy(model).cpu(), copy.deepcopy(pna_model).cpu()
    del model, pna_model
    torch.cuda.empty_cache()
    test = rule_dataset.test
    i = int(rng.integers(test.target_edge_index.shape[1]))
    h, t, r = (int(test.target_edge_index[0, i]), int(test.target_edge_index[1, i]),
               int(test.target_edge_type[i]))
    layer = {"input_dim": 64, "hidden_dims": [64] * 6, "message_func": "distmult",
             "aggregate_func": "sum"}
    run_cfg = {"dataset": {"class": "SyntheticRuleKG", "root": str(ROOT / "kg-datasets"),
                           **SYNTHRULE},
               "model": {"class": "Ultra",
                         "relation_model": dict(layer, **{"class": "RelNBFNet"}),
                         "entity_model": dict(layer, **{"class": "EntityNBFNet"})},
               "checkpoint": str(ckpt)}
    reset_launch_counts()
    t0 = time.perf_counter()
    name, explained = visualize_from_config(run_cfg, h, r, t, device="cuda")
    vis_s = time.perf_counter() - t0
    vis_counts = launch_counts()
    vis_want = attribution_launches(cfg, test.num_nodes, test.num_relations)
    lines = format_paths(explained, name, h, r, t)

    # the CPU references
    cpu_graph = graph.to("cpu")
    t0 = time.perf_counter()
    cpu = [edge_gradients(cpu_model, cpu_graph, h_, t_, r_) for h_, t_, r_ in queries]
    cpu_s = (time.perf_counter() - t0) / len(queries)
    t0 = time.perf_counter()
    pna_cpu = edge_gradients(pna_cpu_model, cpu_graph, *queries[0])
    pna_cpu_s = time.perf_counter() - t0
    del cpu_graph, cpu_model, pna_cpu_model
    t0 = time.perf_counter()
    _, cpu_explained = visualize_from_config(run_cfg, h, r, t, device="cpu")
    cpu_vis_s = time.perf_counter() - t0

    cli = None
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is not None:
        cfg_file = ROOT / "build" / "chip_smoke" / "visualize.yaml"
        cfg_file.write_text(yaml.safe_dump(run_cfg))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_visualize.py"), "-c", str(cfg_file),
             "--head", str(h), "--relation", str(r), "--tail", str(t)],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        cli = {"returncode": proc.returncode, "wall_s": time.perf_counter() - t0,
               "lines": proc.stdout.strip().splitlines(), "stderr": proc.stderr[-2000:]}

    errs = [gradient_errors(g, w, live) for g, w in zip(card, cpu)]
    tf32_errs = [gradient_errors(g, w, live) for g, w in zip(tf32, cpu)]
    pna_errs = gradient_errors(pna_card, pna_cpu, live)
    pna_offs = gradient_offs(pna_card, pna_cpu, live)
    pna_controls = {
        "tf32": {"grad_err_over_max": gradient_errors(pna_tf32, pna_cpu, live),
                 "edges_off": gradient_offs(pna_tf32, pna_cpu, live)},
        "ulp": {"grad_err_over_max": gradient_errors(pna_ulp, pna_card, live),
                "edges_off": gradient_offs(pna_ulp, pna_card, live)}}
    worst, tf32_worst = max(map(max, errs)), max(map(max, tf32_errs))
    finite = all(np.isfinite(g).all() for grads in card + [pna_card] for g in grads)
    nonzero = all(any(np.abs(g[live]).max() > 0 for g in grads) for grads in card + [pna_card])

    top = lambda e: (e.paths[0], e.weights[0]) if e.paths else (None, 0.0)
    (path, weight), (cpu_path, cpu_weight) = top(explained), top(cpu_explained)
    # the CPU's top path, or one that ties with it within the tolerance
    near_top = [p for p, w in zip(cpu_explained.paths, cpu_explained.weights)
                if abs(w - cpu_weight) <= VIS_WEIGHT_RTOL * abs(cpu_weight)]
    record = {
        "queries": queries, "ms_per_call": lat, "ms_per_call_median": statistics.median(lat),
        "cpu_s_per_call": cpu_s, "launches_per_call": as_json(counts[0]),
        "grad_err_over_max": {"worst": worst, "per_query_layer": errs},
        "tf32_control": {"worst": tf32_worst, "per_query_layer": tf32_errs,
                         "within_tolerance": tf32_worst <= VIS_GRAD_REL_TO_MAX},
        "pna": {"query": queries[0], "ms": pna_ms, "peak_mem_mib": pna_peak_mib,
                "resident_mib_before": resident_mib, "cpu_s": pna_cpu_s,
                "grad_err_over_max": pna_errs, "edges_off": pna_offs,
                "live_edges": int(live.sum()), "controls": pna_controls,
                "launches": as_json(pna_counts)},
        "tolerance": f"per layer, max|err| over live edges <= {VIS_GRAD_REL_TO_MAX} of the "
                     f"layer's largest |CPU gradient| (PNA: at most {VIS_MINMAX_EDGES_OFF} of "
                     f"the live edges past it); the top path's importance within rtol "
                     f"{VIS_WEIGHT_RTOL} of the CPU's",
        "rule_kg": {"dataset": name, "V": test.num_nodes, "E": int(test.edge_index.shape[1]),
                    "R": test.num_relations, "query": [h, r, t], "wall_s": vis_s,
                    "gradient_s": explained.gradient_s, "beam_search_s": explained.search_s,
                    "cpu_wall_s": cpu_vis_s, "cpu_gradient_s": cpu_explained.gradient_s,
                    "cpu_beam_search_s": cpu_explained.search_s, "paths": len(explained.paths),
                    "top_path": path, "top_weight": weight, "cpu_top_path": cpu_path,
                    "cpu_top_weight": cpu_weight, "launches": as_json(vis_counts),
                    "lines": lines},
        "cli": None if cli is None else {k: v for k, v in cli.items() if k != "stderr"},
        "pyyaml": yaml is not None,
    }
    print("[visualize] " + json.dumps(record), flush=True)
    check(all(c == want_counts for c in counts),
          f"edge_gradients launched {[as_json(c) for c in counts]}, want {as_json(want_counts)}")
    check(pna_counts == pna_want,
          f"the PNA edge_gradients launched {as_json(pna_counts)}, want {as_json(pna_want)}")
    check(finite and nonzero, "an edge gradient is not finite, or a query's are all 0")
    check(worst <= VIS_GRAD_REL_TO_MAX,
          f"card and CPU edge gradients differ by {worst!r} of a layer's largest")
    edges_off = VIS_MINMAX_EDGES_OFF * int(live.sum())
    check(max(pna_offs) <= edges_off,
          f"card and CPU PNA edge gradients differ by more than {VIS_GRAD_REL_TO_MAX} of a "
          f"layer's largest on {pna_offs} live edges, more than {edges_off:.0f}")
    check(max(pna_controls["tf32"]["edges_off"]) > edges_off,
          f"the PNA TF32 control passed the edge-gradient check "
          f"({pna_controls['tf32']['edges_off']})")
    check(tf32_worst > VIS_GRAD_REL_TO_MAX,
          f"the TF32 control passed the edge-gradient check ({tf32_worst!r}): the check "
          "cannot tell a TF32 call from an f32 one")
    check(vis_counts == vis_want, f"visualize launched {as_json(vis_counts)}, "
                                  f"want {as_json(vis_want)}")
    check(bool(explained.paths) and all(contiguous(p, h, t) for p in explained.paths),
          f"visualize printed no path, or one that is not contiguous from {h} to {t}")
    check(path in near_top and abs(weight - cpu_weight) <= VIS_WEIGHT_RTOL * abs(cpu_weight),
          f"the top path {path} ({weight!r}) is not the CPU's {cpu_path} ({cpu_weight!r})")
    if cli is not None:
        check(cli["returncode"] == 0,
              f"torch_visualize.py exited {cli['returncode']}: {cli['stderr']}")
        strip = lambda ls: [l.split("(importance")[0] for l in ls]
        check(strip(cli["lines"]) == strip(lines),
              f"torch_visualize.py printed {cli['lines']}, want {lines}")
    total = plus(vis_counts, pna_counts)
    for c in counts:
        total = plus(total, c)
    return record, total


def gather_probe_run(graph):
    """The gather probe (``utils/benchlib.py::gather_probe``, what
    ``scripts/torch_gather_probe.py`` runs) on the entity graph: G1 at the
    TPU probes' shape (616,448 rows of a (14,541, 512) table) in bf16 and
    f32 and over the graph's 544,230 edge sources in f32, G2 at (512, 128)
    in f32 and bf16, each equal to its plain version, value for value; its
    G1 and G2 launches read around it. Returns (the kernels line's rows of
    G1 and G2, those launches)."""
    from ultra_tpu_torch.utils.benchlib import gather_probe

    reset_launch_counts()
    record = gather_probe(graph)
    torch.cuda.synchronize()
    counts = launch_counts()
    print("[gather-probe] " + json.dumps(record), flush=True)
    rows = {}
    for name, g in record["gathers"].items():
        print(f"[kernel] {name}: equal={g['equal']}", flush=True)
        rows[name] = kernel_row(
            name, "ultra_tpu_torch/csrc/gather.cu", g["replaces"], g["out_key"], g["ms"],
            g["plain_ms"], (g["bound_ms"], g["bound_by"]), g["max_abs_err"],
            "equal to the plain version", library_ms=g["library_ms"],
            library_call=g["library_call"],
            **{k: g[k] for k in ("lanes", "launch_floor_ms", "flat_grid_floor_ms",
                                 "index_only_ms", "by_lanes") if k in g})
    check(record["equal"], "a gather differs from its plain version (see [gather-probe])")
    check(all(counts[name] for name in ("gather_rows", "gather_lanes")),
          f"the gather probe launched {as_json(counts)}")
    return rows, {name: counts[name] for name in ("gather_rows", "gather_lanes")}


def write_lp_dataset():
    """The [link-prediction] dataset's raw files, in InGram's layout, under a
    fresh ``build/chip_smoke/lp/kg-datasets/ingram/fb/synth/raw`` (see
    LP_INFERENCE); the inference graph's tokens take an ``i`` prefix.
    Returns the ``kg-datasets`` directory, which the YAML's ``root:
    ./kg-datasets/`` names from ``build/chip_smoke/lp``."""
    import shutil

    base = ROOT / "build" / "chip_smoke" / "lp"
    shutil.rmtree(base, ignore_errors=True)
    root = base / "kg-datasets"
    raw = root / "ingram" / "fb" / "synth" / "raw"
    raw.mkdir(parents=True)
    from ultra_tpu_torch.data.kg import SyntheticRuleKG

    train = Path(SyntheticRuleKG(str(ROOT / "kg-datasets"), **SYNTHRULE).raw_dir)
    inference = ROOT / "kg-datasets" / LP_INFERENCE / "raw"
    shutil.copyfile(train / "train.txt", raw / "transductive_train.txt")
    for src, dst, limit in (("train.txt", "inference_graph.txt", None),
                            ("valid.txt", "inf_valid.txt", LP_TRIPLES),
                            ("test.txt", "inf_test.txt", LP_TRIPLES)):
        with open(inference / src) as f:
            lines = f.read().splitlines()[:limit]
        (raw / dst).write_text("".join("\t".join("i" + tok for tok in line.split()) + "\n"
                                       for line in lines))
    return root


def lp_config(ckpt, epochs=0, batch_per_epoch=None):
    """``config/inductive/inference.yaml`` rendered with ``--dataset FBIngram
    --version synth --epochs <epochs> --bpe <batch_per_epoch> --ckpt
    <ckpt>``, as a dict: the card's machine has no jinja2 or PyYAML."""
    layer = {"input_dim": 64, "hidden_dims": [64] * 6, "message_func": "distmult",
             "aggregate_func": "sum", "short_cut": True, "layer_norm": True}
    return {
        "output_dir": "./output",
        "dataset": {"class": "FBIngram", "version": "synth", "root": "./kg-datasets/"},
        "model": {"class": "Ultra", "relation_model": {"class": "RelNBFNet", **layer},
                  "entity_model": {"class": "EntityNBFNet", **layer}},
        "task": {"name": "InductiveInference", "num_negative": NUM_NEGATIVE,
                 "strict_negative": True, "adversarial_temperature": 1, "metric": LP_METRICS},
        "optimizer": {"class": "AdamW", "lr": LR},
        "train": {"batch_size": BATCH, "num_epoch": epochs, "log_interval": 100,
                  "batch_per_epoch": batch_per_epoch},
        "checkpoint": ckpt,
    }


def rank_tolerance(model, graph, trips, index):
    """For each rank :func:`collect_rankings` gives ``trips`` (each batch's
    tail ranks, then its head ranks), how many candidates the filter counts
    score within SCORE_ATOL + SCORE_RTOL * |positive| of the positive on
    ``graph``: how far rounding may move that rank."""
    from ultra_tpu_torch import tasks
    from ultra_tpu_torch.models.nbfnet import ultra_score_all

    t_mask, h_mask = tasks.strict_negative_mask(index, trips)
    h, t, r = (torch.as_tensor(trips[:, i], device=graph.device) for i in range(3))
    num_direct = graph.num_relations // 2
    near = []
    with torch.no_grad():
        for kw, target, mask in ((dict(h_index=h, r_index=r), t, t_mask),
                                 (dict(h_index=t, r_index=r + num_direct, query_r_index=r),
                                  h, h_mask)):
            scores = ultra_score_all(model, graph, **kw)
            pos = scores.gather(1, target[:, None])
            close = (scores - pos).abs() <= SCORE_ATOL + SCORE_RTOL * pos.abs()
            near.append((close.cpu() & torch.as_tensor(mask)).sum(1).numpy())
    return np.concatenate([part[i:i + BATCH] for i in range(0, len(trips), BATCH)
                           for part in near])


def link_prediction_run(cfg, root, dataset):
    """The link-prediction entry point at full ``ultra_3g`` width, as
    ``scripts/torch_run.py`` runs it, on the dataset of
    :func:`write_lp_dataset` under ``root`` (``build_dataset("FBIngram",
    ..., version="synth")``, filtered with the inference graph; ``dataset``
    is its processed cache, loaded) from a ``.pth`` of seed-0 random
    weights, with the config of :func:`lp_config` (checked against the YAML
    where jinja2 and PyYAML are installed). Run A: ``run_link_prediction``
    zero-shot, timed, its launches read around it. Run B: one epoch of
    LP_STEPS steps, timed by the runner's own epoch log record, three
    filtered validations and a checkpoint, its launches read around it.
    Then ``collect_rankings`` of the first LP_RANKED test triples on the
    card and on the CPU, with the seed-0 weights and with run B's
    ``model_epoch_1.pth``; meanwhile, where PyYAML is installed, the command
    line itself in its own process, whose test metrics must be run A's.
    Returns (the ``[link-prediction]`` record, the launches of runs A and
    B)."""
    import ast
    import logging.handlers

    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.train import runner
    from ultra_tpu_torch.train.eval import collect_rankings
    from ultra_tpu_torch.train.loop import init_ultra_params

    base = root.parent
    ckpt = base / "ultra_3g_seed0.pth"
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.save({"model": model.state_dict()}, ckpt)
    zero_shot, fine_tune = lp_config(str(ckpt)), lp_config(str(ckpt), 1, LP_STEPS)
    try:
        from ultra_tpu_torch.utils import config as config_lib

        rendered = config_lib.load_config(
            str(ROOT / "config" / "inductive" / "inference.yaml"),
            {"dataset": "FBIngram", "version": "synth", "epochs": 0, "bpe": "null",
             "ckpt": str(ckpt)})
    except ImportError:  # no jinja2 or PyYAML
        rendered = None
    check(rendered is None or rendered == zero_shot,
          f"inference.yaml renders to {rendered}, not {zero_shot}")

    def run(run_cfg, name):
        run_cfg = copy.deepcopy(run_cfg)
        run_cfg["dataset"]["root"] = str(root)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = runner.run_link_prediction(run_cfg, str(base / name),
                                             checkpoint=run_cfg["checkpoint"], device="cuda")
        torch.cuda.synchronize()
        return results, time.perf_counter() - t0, launch_counts()

    results_a, wall_a, counts_a = run(zero_shot, "zero_shot")
    # the runner logs each epoch's (epoch, mean loss, seconds to the loss's
    # synchronise, steps): run B's step time, its first step included
    log = logging.handlers.BufferingHandler(capacity=10_000)
    logging.getLogger("ultra_tpu_torch").addHandler(log)
    try:
        results_b, wall_b, counts_b = run(fine_tune, "fine_tune")
    finally:
        logging.getLogger("ultra_tpu_torch").removeHandler(log)
    epochs = [r.args for r in log.buffer if r.msg.startswith("epoch ")]
    check(len(epochs) == 1 and epochs[0][3] == LP_STEPS,
          f"run B logged epochs {epochs}, want one of {LP_STEPS} steps")
    _, loss_b, epoch_s, _ = epochs[0]

    train, valid, test = dataset.train, dataset.valid, dataset.test
    valid_launches = validation_launches(cfg, valid.num_nodes, valid.num_relations,
                                         valid.target_edge_type.size)
    test_launches = validation_launches(cfg, test.num_nodes, test.num_relations,
                                        test.target_edge_type.size)
    want_a = plus(valid_launches, test_launches)
    want_b = plus(plus(times(per_step_launches(cfg, train.num_nodes, train.num_relations),
                             LP_STEPS), times(valid_launches, 2)), test_launches)
    epoch_ckpt = base / "fine_tune" / "model_epoch_1.pth"
    trained = (torch.load(epoch_ckpt, weights_only=True, map_location="cpu")["model"]
               if epoch_ckpt.exists() else {})
    check(bool(trained) and all(torch.isfinite(v).all() for v in trained.values()),
          f"{epoch_ckpt} is missing or its weights are not finite")

    # the card's ranks of the first LP_RANKED test triples against the CPU's,
    # with the seed-0 weights (run A's) and the fine-tuned ones (run B's)
    filtered = runner.build_filtered_index(dataset, "FBIngram", "InductiveInference")
    trips = runner.triples_of(test)[:LP_RANKED]
    weights = {"seed0": model.state_dict(), "fine_tuned": trained}

    def ranker(state, device):
        ranked = Ultra(cfg)
        ranked.load_state_dict(state)
        return ranked.to(device).eval()

    card_graph = runner.prepare_graph(test, device="cuda")
    ranks = {}
    for name, state in weights.items():
        card_model = ranker(state, "cuda")
        ranks[name] = {"card": collect_rankings(card_model, card_graph, trips, filtered["test"],
                                                batch_size=BATCH)[0],
                       "near_ties": rank_tolerance(card_model, card_graph, trips,
                                                   filtered["test"])}
    del card_model, card_graph
    torch.cuda.empty_cache()

    cli = proc = None
    try:
        import jinja2  # noqa: F401 - the command line reads the YAML with both
        import yaml  # noqa: F401
    except ImportError:
        pass
    else:
        cli_t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "scripts" / "torch_run.py"), "-c",
             str(ROOT / "config" / "inductive" / "inference.yaml"), "--dataset", "FBIngram",
             "--version", "synth", "--epochs", "0", "--bpe", "null", "--ckpt", str(ckpt)],
            cwd=base, env=dict(os.environ, ULTRA_WORKDIR=str(base / "cli")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        cpu_graph = runner.prepare_graph(test, device="cpu")
        for name, state in weights.items():
            ranks[name]["cpu"] = collect_rankings(ranker(state, "cpu"), cpu_graph, trips,
                                                  filtered["test"], batch_size=BATCH)[0]
        cpu_s = time.perf_counter() - t0
    finally:
        if proc is not None:
            out, err = proc.communicate(timeout=600)
            printed = [line for line in out.splitlines() if line.startswith("{'valid'")]
            cli = {"returncode": proc.returncode, "wall_s": time.perf_counter() - cli_t0,
                   "results": ast.literal_eval(printed[-1]) if printed else None,
                   "stderr": err[-2000:]}
    for by in ranks.values():
        diff = np.abs(by["card"] - by["cpu"])
        by["max_rank_diff"] = int(diff.max())

    record = {
        "dataset": dataset.name,
        "train_graph": {"V": train.num_nodes, "E": int(train.edge_index.shape[1]),
                        "R": train.num_relations},
        "inference_graph": {"V": test.num_nodes, "E": int(test.edge_index.shape[1]),
                            "R": test.num_relations},
        "valid_triples": int(valid.target_edge_type.size),
        "test_triples": int(test.target_edge_type.size),
        "zero_shot": {"wall_s": wall_a, "results": results_a, "launches": as_json(counts_a)},
        "fine_tune": {"wall_s": wall_b, "steps": LP_STEPS, "epoch_s": epoch_s,
                      "ms_per_step": 1e3 * epoch_s / LP_STEPS, "loss": loss_b,
                      "results": results_b, "launches": as_json(counts_b)},
        "ranks": {"triples": LP_RANKED, "cpu_s": cpu_s,
                  **{name: {k: v.tolist() if isinstance(v, np.ndarray) else v
                            for k, v in by.items()} for name, by in ranks.items()}},
        "cli": None if cli is None else {k: v for k, v in cli.items() if k != "stderr"},
        "tolerance": f"ranks equal but by the counted candidates within {SCORE_ATOL} + "
                     f"{SCORE_RTOL} * |positive| of the positive's score on the card",
    }
    print("[link-prediction] " + json.dumps(record), flush=True)
    for name, by in ranks.items():
        print(f"[link-prediction] ranks {name}: largest card-CPU rank difference "
              f"{by['max_rank_diff']}, allowed near ties {int(by['near_ties'].min())} to "
              f"{int(by['near_ties'].max())} a rank", flush=True)
    check(counts_a == want_a, f"zero-shot run_link_prediction launched {as_json(counts_a)}, "
                              f"want {as_json(want_a)}")
    check(counts_b == want_b, f"fine-tuning run_link_prediction launched {as_json(counts_b)}, "
                              f"want {as_json(want_b)}")
    # random weights rank a few test triples first, or none: zero-shot, a
    # hits@k may be 0; after fine-tuning, MRR and every hits@k are above 0
    for name, results, hits_above_0 in (("zero-shot", results_a, False),
                                        ("fine-tuning", results_b, True)):
        for split, metrics in results.items():
            hits = [metrics[m] for m in LP_METRICS[2:]]
            check(list(metrics) == LP_METRICS and all(np.isfinite(list(metrics.values()))),
                  f"{name} {split} metrics {metrics}")
            check(0 < metrics["mrr"] <= 1 and all(0 <= h <= 1 for h in hits)
                  and (min(hits) > 0 or not hits_above_0),
                  f"{name} {split}: MRR or a hits@k out of range: {metrics}")
    for name, by in ranks.items():
        check(by["card"].shape == by["cpu"].shape == by["near_ties"].shape == (2 * LP_RANKED,),
              f"{name} ranks of shapes {by['card'].shape}, {by['cpu'].shape}, "
              f"{by['near_ties'].shape}")
        check(bool(np.all(np.abs(by["card"] - by["cpu"]) <= by["near_ties"])),
              f"{name}: card ranks {by['card'].tolist()} and CPU ranks {by['cpu'].tolist()} "
              f"differ by more than the near ties {by['near_ties'].tolist()}")
    if cli is not None:
        check(cli["returncode"] == 0, f"torch_run.py exited {cli['returncode']}: {cli['stderr']}")
        check(cli["results"] is not None and cli["results"]["test"] == results_a["test"],
              f"torch_run.py printed {cli['results']}, want run A's test metrics "
              f"{results_a['test']}")
    return record, plus(counts_a, counts_b)


def clqa_config(ckpt, epochs=0, bpe=None):
    """``config/ultraquery/transductive_synth.yaml`` rendered with
    ``--dataset FB15k237LogicalQuery --root <CLQA_ROOT> --epochs <epochs>
    --bs 8 --bpe <bpe> --threshold 0.8 --ultra_ckpt null --qe_ckpt
    <ckpt>``, as a dict: the card's machine may have no jinja2 or PyYAML."""
    layer = {"input_dim": 64, "hidden_dims": [64] * 6, "message_func": "distmult",
             "aggregate_func": "sum", "short_cut": True, "layer_norm": True}
    return {
        "output_dir": "./output",
        "dataset": {"class": "FB15k237LogicalQuery", "root": str(ROOT / CLQA_ROOT)},
        "model": {"class": "UltraQuery", "logic": "product", "dropout_ratio": 0.25,
                  "threshold": 0.8, "more_dropout": 0.0,
                  "model": {"class": "Ultra", "relation_model": {"class": "RelNBFNet", **layer},
                            "entity_model": {"class": "QueryNBFNet", **layer}}},
        "task": {"name": "ComplexQuery", "adversarial_temperature": 0.2,
                 "metric": CLQA_METRICS},
        "optimizer": {"class": "AdamW", "lr": LR},
        "train": {"batch_size": BATCH, "num_epoch": epochs, "log_interval": 20,
                  "batch_per_epoch": bpe},
        "ultra_ckpt": None,
        "ultraquery_ckpt": ckpt,
    }


def clqa_launches(cfg, dataset, graph, splits=(1, 2)):
    """What zero-shot evaluation of ``dataset``'s valid and test queries
    (``splits``, indices into ``split_ranges``) launches, by wrapper and
    output shape: per split, the precompute's
    chunks of PRECOMPUTE_CHUNK relations through the relation model, and
    per batch of BATCH queries (the last one padded by repeating its last
    query) the entity model once for each round of its projection schedule
    (``query/executor.py::projection_schedule``; no pad rounds)."""
    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.executor import projection_schedule

    dim = cfg.entity_model.input_dim
    chunks = -(-graph.num_relations // PRECOMPUTE_CHUNK)
    counts = no_launches()
    rounds = 0
    for lo, hi in (dataset.split_ranges()[i] for i in splits):
        counts = plus(counts, times(forward_launches(cfg.relation_model, graph.num_relations,
                                                     PRECOMPUTE_CHUNK * dim), chunks))
        for start in range(lo, hi, BATCH):
            take = np.arange(start, min(start + BATCH, hi))
            take = np.concatenate([take, np.repeat(take[-1:], BATCH - len(take))])
            rounds += projection_schedule(ops.decompose(dataset.queries[take])[0])[3]
    entity = forward_launches(cfg.entity_model, graph.num_nodes, BATCH * dim)
    return plus(counts, times(entity, rounds)), rounds


def clqa_ranks(model, graph, dataset, indices, qcfg):
    """(filtered ranks of the hard answers, every probability (B, V), the
    hard answers' mask (B, V)) of ``dataset``'s queries ``indices`` on
    ``graph``'s device, in batches of BATCH, as ``evaluate_queries`` ranks
    them; the ranks follow the mask's row-major order."""
    from ultra_tpu_torch.query import metrics as qmetrics
    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.trainer import answers_to_mask, make_query_forward_grouped
    from ultra_tpu_torch.train.eval import precompute_relation_representations

    fwd = make_query_forward_grouped(model, qcfg)
    rel_reprs = precompute_relation_representations(model, graph)
    preds = []
    for start in range(0, len(indices), BATCH):
        kind, operand = ops.decompose(dataset.queries[indices[start:start + BATCH]])
        preds.append(fwd(graph, kind, operand, rel_reprs).cpu().numpy())
    pred = np.concatenate(preds)
    v = graph.num_nodes
    easy = answers_to_mask([dataset.easy_answers[i] for i in indices], v)
    hard = answers_to_mask([dataset.hard_answers[i] for i in indices], v)
    rank = qmetrics.batch_evaluate(pred, easy, hard)[0]
    return rank, 1.0 / (1.0 + np.exp(-pred.astype(np.float64))), hard


def http_call(addr, method, path, payload=None, raw=None):
    """(status, decoded JSON answer, client milliseconds) of one request."""
    from http.client import HTTPConnection

    conn = HTTPConnection(*addr, timeout=120)
    t0 = time.perf_counter()
    conn.request(method, path, body=raw if raw is not None else
                 (None if payload is None else json.dumps(payload)))
    resp = conn.getresponse()
    out = json.loads(resp.read())
    ms = 1e3 * (time.perf_counter() - t0)
    conn.close()
    return resp.status, out, ms


def clqa_http(model, graph, dataset, smi):
    """``make_http_server`` on port 0 over an ``UltraPredictor`` of
    ``model`` on ``graph`` (the card's): /healthz, /v1/meta, a /v1/predict
    of BATCH queries in tail and head mode against ``predict_tails``, a
    /v1/query of one query of each of the dataset's types against the
    executor called directly, malformed requests against 400, then
    CLQA_HTTP_REQUESTS timed requests to each endpoint. Returns the
    record."""
    import threading

    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.datasets import STRUCT2TYPE
    from ultra_tpu_torch.query.executor import QueryConfig
    from ultra_tpu_torch.serve import UltraPredictor
    from ultra_tpu_torch.server import PredictionService, make_http_server

    pred = UltraPredictor(model, graph, batch_size=BATCH, device="cuda")
    service = PredictionService(pred, qcfg=QueryConfig(logic="product", dropout_ratio=0.0,
                                                       threshold=0.8))
    httpd = make_http_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    addr = httpd.server_address
    rng = np.random.default_rng(0)
    v, num_rel = graph.num_nodes, graph.num_relations
    try:
        health = http_call(addr, "GET", "/healthz")[:2]
        meta = http_call(addr, "GET", "/v1/meta")[1]

        h = rng.integers(0, v, BATCH)
        r = rng.integers(0, num_rel // 2, BATCH)
        modes = ["tail", "head"] * (BATCH // 2)
        status, predicted, _ = http_call(addr, "POST", "/v1/predict", {"queries": [
            {"head": int(a), "relation": int(b), "mode": m, "k": TOPK}
            for a, b, m in zip(h, r, modes)]})
        direct_s, direct_i = pred.predict_tails(
            h, np.where(np.array(modes) == "head", r + num_rel // 2, r), k=TOPK)
        predict_equal = status == 200 and all(
            res["entities"] == direct_i[i].tolist()
            and res["scores"] == [round(float(x), 6) for x in direct_s[i]]
            for i, res in enumerate(predicted["results"]))

        def nested(struct):
            if struct in ("e", "r"):
                return int(rng.integers(v if struct == "e" else num_rel))
            return {"n": -2, "u": -1}.get(struct) if isinstance(struct, str) else \
                [nested(x) for x in struct]

        type2struct = {t: st for st, t in STRUCT2TYPE.items()}
        queries = [nested(type2struct[t]) for t in dataset.id2type]
        status, answered, _ = http_call(addr, "POST", "/v1/query",
                                        {"queries": queries, "k": TOPK})
        from ultra_tpu_torch.server import _as_tuples

        progs = [ops.from_nested(_as_tuples(q)) for q in queries]
        kind, operand = ops.decompose(ops.pad_queries(progs, max(map(len, progs))))
        fwd, rel_reprs = service._query_forward()
        with torch.no_grad():
            prob = torch.sigmoid(fwd(graph, kind, operand, rel_reprs).double())
            top_p, top_i = (t.cpu().numpy() for t in torch.topk(prob, TOPK, dim=-1))
        query_equal = status == 200 and all(
            res["entities"] == top_i[i].tolist()
            and res["probs"] == [round(float(x), 6) for x in top_p[i]]
            for i, res in enumerate(answered["results"]))

        malformed = {
            "empty": ("/v1/predict", {"queries": []}, None),
            "head out of range": ("/v1/predict", {"queries": [{"head": v, "relation": 0}]},
                                  None),
            "boolean id": ("/v1/predict", {"queries": [{"head": True, "relation": 0}]}, None),
            "entity out of range": ("/v1/query", {"queries": [[v, [0]]]}, None),
            "one-branch intersection": ("/v1/query", {"queries": [[[3, [1]]]]}, None),
            "bad JSON": ("/v1/query", None, "{not json"),
        }
        refused = {name: http_call(addr, "POST", path, payload, raw)[0]
                   for name, (path, payload, raw) in malformed.items()}

        latency = {}
        for path, payload in (
                ("/v1/predict", {"queries": [{"head": int(a), "relation": int(b), "k": TOPK}
                                             for a, b in zip(h, r)]}),
                ("/v1/query", {"queries": queries, "k": TOPK})):
            ms = []
            for _ in range(CLQA_HTTP_REQUESTS):
                status, _, t = http_call(addr, "POST", path, payload)
                check(status == 200, f"{path} answered {status}")
                ms.append(t)
            latency[path] = {"p50_ms": statistics.median(ms), "min_ms": min(ms),
                             "max_ms": max(ms), "queries": len(payload["queries"])}
        server_side = http_call(addr, "GET", "/v1/meta")[1]["latency_ms"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    record = {"health": list(health), "meta": meta, "predict_equal": predict_equal,
              "query_equal": query_equal, "query_types": list(dataset.id2type),
              "refused": refused, "latency": latency, "server_side_latency_ms": server_side,
              "card": smi}
    print("[clqa] http " + json.dumps(record), flush=True)
    for path, lat in latency.items():
        print(f"[clqa] {path} p50 {lat['p50_ms']:.2f} ms a request of {lat['queries']} "
              f"queries ({smi})", flush=True)
    check(not thread.is_alive(), "the HTTP server's thread did not stop")
    check(health == (200, {"status": "ok"}) and meta["num_entities"] == v,
          f"/healthz {health}, /v1/meta {meta}")
    check(predict_equal, "/v1/predict differs from predict_tails")
    check(query_equal, "/v1/query differs from the executor called directly")
    check(all(status == 400 for status in refused.values()),
          f"malformed requests were answered {refused}, want 400")
    return record


def clqa_run(cfg, dataset, graph, smi):
    """UltraQuery zero-shot at ``ultra_3g`` width, as
    ``scripts/torch_run_query.py`` runs it (its ``run``, with
    :func:`clqa_config`, from a ``.pth`` of seed-0 random weights in
    UltraQuery's ``model.model.*`` layout): every valid and test query
    answered on the card, timed, its launches read around it and held
    against :func:`clqa_launches`; the card's ranks of the first
    CLQA_RANKED test queries of each type held against the CPU's; then the
    HTTP server (:func:`clqa_http`) on ``graph``. Returns (the ``[clqa]``
    record, the evaluation's launches)."""
    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.query.executor import QueryConfig
    from ultra_tpu_torch.train.loop import init_ultra_params

    base = ROOT / "build" / "chip_smoke" / "clqa"
    base.mkdir(parents=True, exist_ok=True)
    ckpt = base / "ultraquery_seed0.pth"
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.save({"model": {f"model.model.{k}": w for k, w in model.state_dict().items()}}, ckpt)
    run_cfg = clqa_config(str(ckpt))
    try:
        from ultra_tpu_torch.utils import config as config_lib

        rendered = config_lib.load_config(
            str(ROOT / "config" / "ultraquery" / "transductive_synth.yaml"),
            {"dataset": "FB15k237LogicalQuery", "root": str(ROOT / CLQA_ROOT), "epochs": 0,
             "bs": BATCH, "bpe": "null", "threshold": 0.8, "ultra_ckpt": "null",
             "qe_ckpt": str(ckpt)})
    except ImportError:  # no jinja2 or PyYAML
        rendered = None
    check(rendered is None or rendered == run_cfg,
          f"transductive_synth.yaml renders to {rendered}, not {run_cfg}")

    cli = load_script("torch_run_query")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = cli.run(run_cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    want, rounds = clqa_launches(cfg, dataset, graph)
    batches = sum(-(-int(hi - lo) // BATCH) for lo, hi in dataset.split_ranges()[1:])

    # the card's ranks of CLQA_RANKED test queries of each type against the CPU's
    lo, hi = dataset.split_ranges()[2]
    picked = np.concatenate([lo + np.nonzero(dataset.types[lo:hi] == t)[0][:CLQA_RANKED]
                             for t in range(len(dataset.id2type))])
    qcfg = QueryConfig(logic="product", dropout_ratio=0.0, threshold=0.8)
    card_model = Ultra(cfg)
    card_model.load_state_dict(model.state_dict())
    card_model = card_model.cuda().eval()
    card_rank, card_prob, hard = clqa_ranks(card_model, graph, dataset, picked, qcfg)
    t0 = time.perf_counter()
    from ultra_tpu_torch.query.trainer import prepare_query_graph

    cpu_rank, cpu_prob, _ = clqa_ranks(model.eval(),
                                       prepare_query_graph(dataset.graphs[2], "cpu"),
                                       dataset, picked, qcfg)
    cpu_s = time.perf_counter() - t0
    # per hard answer, the other candidates within 2 * CLQA_PROB_ATOL of it on the card
    rows, cols = np.nonzero(hard)
    card_p, cpu_p = card_prob[rows, cols], cpu_prob[rows, cols]
    near = (np.abs(card_prob[rows] - card_p[:, None]) <= 2 * CLQA_PROB_ATOL).sum(axis=1) - 1
    rank_diff = np.abs(card_rank - cpu_rank)

    clqa_http(card_model, graph, dataset, smi)  # prints its own record
    record = {
        "dataset": dataset.name,
        "graph": {"V": graph.num_nodes, "E": int(graph.csr.col.numel()),
                  "R": graph.num_relations,
                  "rel_graph_E": int(graph.relation_graph.csr.col.numel())},
        "queries": {split: int(hi - lo) for split, (lo, hi)
                    in zip(("valid", "test"), dataset.split_ranges()[1:])},
        "types": list(dataset.id2type), "batches": batches, "rounds": rounds,
        "wall_s": wall_s, "ms_per_batch": 1e3 * wall_s / batches, "results": results,
        "launches": as_json(counts), "want_launches": as_json(want),
        "ranks": {"queries": len(picked), "answers": int(len(card_rank)),
                  "max_rank_diff": int(rank_diff.max()),
                  "moved": int((rank_diff > 0).sum()),
                  "near_ties_max": int(near.max()), "answers_with_near_ties": int((near > 0).sum()),
                  "max_prob_diff": float(np.abs(card_p - cpu_p).max()), "cpu_s": cpu_s},
        "tolerance": f"answer probabilities within {CLQA_PROB_ATOL}; ranks equal but by the "
                     f"candidates within {2 * CLQA_PROB_ATOL} of the answer on the card",
    }
    print("[clqa] " + json.dumps(record), flush=True)
    for split, metrics in results.items():
        print(f"[clqa] {split} metrics ({record['queries'][split]} queries): "
              + json.dumps({k: metrics[k] for k in CLQA_METRICS}), flush=True)
    check(counts == want, f"zero-shot CLQA launched {as_json(counts)}, want {as_json(want)}")
    for split, metrics in results.items():
        check(all(np.isfinite(list(metrics.values()))), f"{split} metrics {metrics}")
        check(0 < metrics["mrr"] <= 1 and all(0 <= metrics[m] <= 1 for m in CLQA_METRICS[1:4]),
              f"{split}: MRR or a hits@k out of range: {metrics}")
        check(all(f"[{t}] mrr" in metrics for t in dataset.id2type),
              f"{split} metrics lack a type: {sorted(metrics)}")
    check(card_rank.shape == cpu_rank.shape == near.shape and len(card_rank) > 0,
          f"ranks of shapes {card_rank.shape}, {cpu_rank.shape}, {near.shape}")
    check(float(np.abs(card_p - cpu_p).max()) <= CLQA_PROB_ATOL,
          f"card and CPU answer probabilities differ by {np.abs(card_p - cpu_p).max()!r}")
    check(bool(np.all(rank_diff <= near)),
          f"card and CPU ranks differ by more than the near ties at "
          f"{np.nonzero(rank_diff > near)[0].tolist()}")
    return record, counts


def load_script(name):
    """``scripts/<name>.py`` as a module (its functions, not its ``main``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class LogLines:
    """The messages logged to the port's logger while in the block."""

    def __enter__(self):
        import logging

        self.lines = []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda record: self.lines.append(record.getMessage())
        self.logger = logging.getLogger("ultra_tpu_torch")
        self.logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def without_zeros(counts):
    return {name: {k: n for k, n in by_shape.items() if n} for name, by_shape in counts.items()}


def grad_ratio(card, cpu):
    """({tensor: max|err| / max|grad_cpu|}, every tensor within
    GRAD_REL_TO_MAX of its largest entry plus GRAD_ATOL) of two models'
    ``.grad``."""
    cpu_grads = dict(cpu.named_parameters())
    ratio, ok = {}, True
    for k, p in card.named_parameters():
        got, want = p.grad.detach().cpu(), cpu_grads[k].grad
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        ok &= err <= GRAD_REL_TO_MAX * scale + GRAD_ATOL
        ratio[k] = err / max(scale, 1e-30)
    return ratio, ok


def pretrain_config(epochs, bpe):
    """``config/transductive/pretrain_synth.yaml`` rendered with ``--epochs
    <epochs> --bpe <bpe>``, as a dict (the card's machine may have no jinja2
    or PyYAML), its root made absolute."""
    layer = {"input_dim": 64, "hidden_dims": [64] * 6, "message_func": "distmult",
             "aggregate_func": "sum", "short_cut": True, "layer_norm": True}
    cfg = {
        "output_dir": "./output",
        "dataset": {"class": "JointDataset", "graphs": [dict(m) for m in PRETRAIN_MEMBERS],
                    "root": "./kg-datasets/"},
        "model": {"class": "Ultra", "relation_model": {"class": "RelNBFNet", **layer},
                  "entity_model": {"class": "EntityNBFNet", **layer}},
        "task": {"name": "MultiGraphPretraining", "num_negative": PRETRAIN_NEGATIVE,
                 "strict_negative": True, "adversarial_temperature": 1,
                 "metric": ["mr", "mrr", "hits@1", "hits@3", "hits@10"]},
        "optimizer": {"class": "AdamW", "lr": LR},
        "train": {"batch_size": PRETRAIN_BATCH, "num_epoch": epochs, "log_interval": 100,
                  "batch_per_epoch": bpe, "fast_test": 300},
    }
    try:
        from ultra_tpu_torch.utils import config as config_lib

        rendered = config_lib.load_config(
            str(ROOT / "config" / "transductive" / "pretrain_synth.yaml"),
            {"epochs": epochs, "bpe": bpe})
    except ImportError:  # no jinja2 or PyYAML
        rendered = None
    check(rendered is None or rendered == cfg,
          f"pretrain_synth.yaml renders to {rendered}, not {cfg}")
    cfg["dataset"]["root"] = str(ROOT / "kg-datasets")
    return cfg


def pretrain_run(cfg, graphs):
    """Pretraining on the mixture at ``ultra_3g`` width: ``run`` of
    ``scripts/torch_pretrain.py`` (what the command line runs) on
    :func:`pretrain_config` with PRETRAIN_STEPS steps, timed, its launches
    read around it; then, on ``graphs`` (the members' PretrainGraphs on the
    card), the host's sampling timed over the mixture's draws, one step of
    the smallest member held against the same step on the CPU (loss to
    LOSS_RTOL, each gradient to GRAD_REL_TO_MAX of its tensor's largest
    entry), and PRETRAIN_WARM + PRETRAIN_TIMED steps on each member, timed,
    with their peak memory and the first timed step's launches asserted
    (:func:`per_step_launches` at batch PRETRAIN_BATCH). Returns (the
    ``[pretrain]`` record, the run's launches)."""
    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params, make_train_step
    from ultra_tpu_torch.train.runner import prepare_graph

    cli = load_script("torch_pretrain")
    run_cfg = pretrain_config(1, PRETRAIN_STEPS)
    workdir = ROOT / "build" / "chip_smoke" / "pretrain"
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with LogLines() as log:
        trained = cli.run(run_cfg, str(workdir), seed=0, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    run_record = {"wall_s": wall_s, "steps": PRETRAIN_STEPS,
                  "log": [l for l in log if "avg" in l or "valid[" in l],
                  "files": sorted(os.listdir(workdir))}

    # the host's sampling and masks, over the mixture's draws
    rng = np.random.default_rng(1)
    by_member = {gi: [] for gi in range(len(graphs.datasets))}
    host_ms = []
    need = 1 + PRETRAIN_WARM + PRETRAIN_TIMED
    while min(len(b) for b in by_member.values()) < need and len(host_ms) < 400:
        t0 = time.perf_counter()
        gi, batch, ew = graphs.sample(rng, PRETRAIN_BATCH, PRETRAIN_NEGATIVE, True, False)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        by_member[gi].append((batch, ew))
    check(min(len(b) for b in by_member.values()) >= need,
          f"{len(host_ms)} draws gave {[len(b) for b in by_member.values()]} batches a member")

    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    state = init_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY)
    step = make_train_step(adversarial_temperature=1.0, num_negative=PRETRAIN_NEGATIVE)
    on_card = lambda b: tuple(torch.as_tensor(a, device="cuda") for a in b)  # noqa: E731

    # one step of the smallest member on the card and the CPU
    small = min(range(len(graphs.datasets)),
                key=lambda gi: graphs.datasets[gi].train.edge_index.shape[1])
    batch = by_member[small][0]
    card_loss = float(step(state, graphs.train_graphs[small], *on_card(batch)))
    t0 = time.perf_counter()
    cpu_model = Ultra(cfg)
    cpu_model.load_state_dict(init)
    cpu_state = init_train_state(cpu_model, lr=LR, weight_decay=WEIGHT_DECAY)
    cpu_loss = float(step(cpu_state, prepare_graph(graphs.datasets[small].train, device="cpu"),
                          *(torch.as_tensor(a) for a in batch)))
    cpu_s = time.perf_counter() - t0
    ratio, grads_ok = grad_ratio(state.model, cpu_model)
    worst = max(ratio, key=ratio.get)
    del cpu_model, cpu_state

    members, launches_ok = [], True
    for gi, d in enumerate(graphs.datasets):
        g = graphs.train_graphs[gi]
        batches = [on_card(b) for b in by_member[gi][1:need]]
        losses = [step(state, g, *b) for b in batches[:PRETRAIN_WARM]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        for j, b in enumerate(batches[PRETRAIN_WARM:]):
            if j == 0:
                reset_launch_counts()
            t0 = time.perf_counter()
            losses.append(step(state, g, *b))
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t0))
            if j == 0:
                first = launch_counts()
        want = per_step_launches(cfg, g.num_nodes, g.num_relations, batch=PRETRAIN_BATCH)
        launches_ok &= first == want
        members.append({
            "name": d.name, "V": g.num_nodes, "E": int(g.csr.col.numel()),
            "R": g.num_relations, "rel_graph_E": int(g.relation_graph.csr.col.numel()),
            "step_ms_median": statistics.median(lat), "step_ms_min": min(lat),
            "step_ms_max": max(lat), "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
            "losses": [float(l) for l in losses], "launches_per_step": as_json(first),
            "want_launches_per_step": as_json(want)})

    record = {
        "run": run_record, "members": members,
        "host_ms_per_step": {"median": statistics.median(host_ms), "min": min(host_ms),
                             "max": max(host_ms), "draws": len(host_ms)},
        "cpu_step": {"member": graphs.datasets[small].name, "card_loss": card_loss,
                     "cpu_loss": cpu_loss, "loss_abs_err": abs(card_loss - cpu_loss),
                     "grad_err_over_max": {"worst": worst, "value": ratio[worst],
                                           "median": statistics.median(ratio.values())},
                     "cpu_s": cpu_s},
        "launches": as_json(counts),
        "tolerance": f"loss rtol {LOSS_RTOL}; per tensor max|err| <= {GRAD_REL_TO_MAX} * "
                     f"max|grad_cpu| + {GRAD_ATOL}",
    }
    print("[pretrain] " + json.dumps(record), flush=True)
    check({"model_latest.pth", "model_final.pth", "model_epoch_1.pth"} <= set(
        run_record["files"]), f"pretraining wrote {run_record['files']}")
    check(all(torch.isfinite(p).all() for p in trained.parameters()),
          "pretrained weights not finite")
    check(any("avg valid mrr" in l for l in log), "pretraining logged no validation")
    for gi, g in enumerate(graphs.train_graphs):
        check(counts["rspmm_sum_fwd"].get(
            (g.num_nodes, PRETRAIN_BATCH * cfg.entity_model.input_dim), 0) > 0,
              f"member {gi} took no step in the run")
    check(launches_ok, "a member's step launched other kernels than per_step_launches says: "
                       + json.dumps([(m["launches_per_step"], m["want_launches_per_step"])
                                     for m in members]))
    check(all(np.isfinite(m["losses"]).all() for m in members), "a step's loss is not finite")
    check(abs(card_loss - cpu_loss) <= LOSS_RTOL * abs(cpu_loss),
          f"card loss {card_loss!r} vs CPU {cpu_loss!r}")
    check(grads_ok, f"card and CPU gradients differ; worst {worst}: {ratio[worst]!r}")
    return record, counts


def query_step_passes(kind, grouped, accum):
    """The projection passes of one query train step on the batch
    ``kind``, as [(passes, rows a pass)]: per slot, one for each slot where
    some query projects; grouped, one for each round of each of the
    ``gcd(B, accum)`` micro-batches' schedules."""
    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.executor import projection_schedule

    b = kind.shape[0]
    if grouped:
        micro = math.gcd(b, accum)
        return [(projection_schedule(kind[rows])[3], b // micro)
                for rows in np.split(np.arange(b), micro)]
    return [(int((kind == ops.K_PROJECTION).any(axis=0).sum()), b)]


def query_step_launches(cfg, kind, grouped, accum, num_nodes, num_rel):
    """What one query train step on the batch ``kind`` launches: a step's
    launches (:func:`per_step_launches`) for each projection pass
    (:func:`query_step_passes`) at its rows."""
    counts = no_launches()
    for n, rows in query_step_passes(kind, grouped, accum):
        counts = plus(counts, times(per_step_launches(cfg, num_nodes, num_rel, batch=rows), n))
    return counts


CLQA_STEP_KINDS = (("per-slot", False, 1), ("grouped", True, 1), ("grouped-accum2", True, 2))


def clqa_training_run(cfg, dataset):
    """UltraQuery training at ``ultra_3g`` width on the repo's BetaE data:
    ``run`` of ``scripts/torch_run_query.py`` (what the command line runs)
    with :func:`clqa_config` at --epochs 1 --bpe CLQA_TRAIN_STEPS, per slot
    and grouped with grad_accum 2, each timed with its launches held
    against the projection schedule (its steps, the epoch's validation, the
    final evaluation); then each step kind of CLQA_STEP_KINDS on batches
    drawn from the training queries: the first step held against the same
    step on the CPU on the same dropout plan, then CLQA_TRAIN_WARM warm and
    CLQA_TRAIN_TIMED timed steps with the host's planning (the symbolic
    machine, the masker and the masks' copy to the card) timed apart, peak
    memory, and the launches of each timed step asserted
    (:func:`query_step_launches`); then ``run`` on a JointQueryDataset of
    the repo's set and a generated member (QUERY_MIX_MEMBER). Returns (the
    ``[clqa-training]`` record, the three runs' launches)."""
    from ultra_tpu_torch.data.synthetic_queries import write_betae_dataset
    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.executor import (
        QueryConfig, graphs_for_slots, projection_schedule, simulate_symbolic,
        simulate_symbolic_grouped,
    )
    from ultra_tpu_torch.query.trainer import (
        answers_to_mask, dropout_planner, graph_host, make_grouped_query_train_step,
        make_query_train_step, prepare_query_graph,
    )
    from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params

    base = ROOT / "build" / "chip_smoke" / "clqa_training"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    model0 = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ckpt = base / "ultraquery_seed0.pth"
    torch.save({"model": {f"model.model.{k}": w for k, w in model0.state_dict().items()}}, ckpt)
    cli = load_script("torch_run_query")
    graph = prepare_query_graph(dataset.graphs[0], device="cuda")
    v, r = graph.num_nodes, graph.num_relations
    (tr_lo, tr_hi), (va_lo, va_hi), _ = dataset.split_ranges()
    total = no_launches()
    runs = {}

    # the command line's function, per slot and grouped with grad_accum 2
    for mode, extra in (("per-slot", {}), ("grouped-accum2", {"grouped_projections": True,
                                                               "grad_accum": 2})):
        run_cfg = clqa_config(str(ckpt), epochs=1, bpe=CLQA_TRAIN_STEPS)
        run_cfg["train"].update(extra)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with LogLines() as log:
            results = cli.run(run_cfg, seed=0, device="cuda", workdir=str(base / mode))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        total = plus(total, counts)
        perm = np.random.default_rng(0).permutation(np.arange(tr_lo, tr_hi))
        want = no_launches()
        for step in range(CLQA_TRAIN_STEPS):
            kind = ops.decompose(dataset.queries[perm[step * BATCH:(step + 1) * BATCH]])[0]
            want = plus(want, query_step_launches(cfg, kind, "grouped" in mode,
                                                  extra.get("grad_accum", 1), v, r))
        want = plus(plus(want, clqa_launches(cfg, dataset, graph, splits=(1,))[0]),
                    clqa_launches(cfg, dataset, graph)[0])
        runs[mode] = {"wall_s": wall_s, "launches": as_json(counts),
                      "log": [l for l in log if "avg bce" in l or "valid after" in l],
                      "results": {split: {k: m[k] for k in CLQA_METRICS}
                                  for split, m in results.items()}}
        check(without_zeros(counts) == without_zeros(want),
              f"{mode} run launched {as_json(counts)}, want {as_json(want)}")
        for split, m in results.items():
            check(all(np.isfinite(list(m.values()))) and 0 < m["mrr"] <= 1,
                  f"{mode} {split} metrics {m}")
        check({"model_latest.pth", "model_epoch_1.pth"} <= set(os.listdir(base / mode)),
              f"{mode} wrote {os.listdir(base / mode)}")

    # each step kind: a step against the CPU, then timed steps
    qg = dataset.graphs[0]
    cpu_graph = prepare_query_graph(qg, device="cpu")
    host = graph_host(qg, graph)
    t0 = time.perf_counter()
    planner = dropout_planner(host, graph)
    planner_s = time.perf_counter() - t0
    qcfg = QueryConfig(logic="product", threshold=0.8, dropout_ratio=0.25)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(1 + CLQA_TRAIN_WARM + CLQA_TRAIN_TIMED):
        take = rng.choice(np.arange(tr_lo, tr_hi), BATCH, replace=False)
        kind, operand = ops.decompose(dataset.queries[take])
        batches.append((kind, operand, answers_to_mask([dataset.easy_answers[i] for i in take],
                                                       v).astype(np.float32)))
    steps, all_ok = {}, True
    for mode, grouped, accum in CLQA_STEP_KINDS:
        step_fn = (make_grouped_query_train_step(qcfg, 0.2, grad_accum=accum) if grouped
                   else make_query_train_step(qcfg, 0.2))

        def plan(kind, operand):
            if grouped:
                return simulate_symbolic_grouped(kind, operand, *projection_schedule(kind), host,
                                                 qcfg, rng, planner)
            return simulate_symbolic(kind, operand, host, qcfg, rng, planner=planner)

        kind, operand, target = batches[0]
        first_plan = plan(kind, operand)
        card = Ultra(cfg)
        card.load_state_dict(model0.state_dict())
        state = init_train_state(card.cuda(), lr=LR, weight_decay=WEIGHT_DECAY)
        card_loss = float(step_fn(state, graphs_for_slots(graph, first_plan), kind, operand,
                                  target))
        t0 = time.perf_counter()
        cpu = Ultra(cfg)
        cpu.load_state_dict(model0.state_dict())
        cpu_loss = float(step_fn(init_train_state(cpu, lr=LR, weight_decay=WEIGHT_DECAY),
                                 graphs_for_slots(cpu_graph, first_plan), kind, operand, target))
        cpu_s = time.perf_counter() - t0
        ratio, grads_ok = grad_ratio(state.model, cpu)
        worst = max(ratio, key=ratio.get)

        losses, plan_ms, lat, launches_ok, peak = [], [], [], True, None
        for j, (kind, operand, target) in enumerate(batches[1:]):
            timed = j >= CLQA_TRAIN_WARM
            if j == CLQA_TRAIN_WARM:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            slot_graphs = graphs_for_slots(graph, plan(kind, operand))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            reset_launch_counts()
            losses.append(float(step_fn(state, slot_graphs, kind, operand, target)))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if timed:
                plan_ms.append(1e3 * (t1 - t0))
                lat.append(1e3 * (t2 - t1))
                launches_ok &= without_zeros(launch_counts()) == without_zeros(
                    query_step_launches(cfg, kind, grouped, accum, v, r))
        peak = torch.cuda.max_memory_allocated() / 2**20
        steps[mode] = {
            "step_ms_median": statistics.median(lat), "step_ms_min": min(lat),
            "step_ms_max": max(lat), "host_plan_ms_median": statistics.median(plan_ms),
            "host_plan_ms_max": max(plan_ms), "peak_mem_mib": peak, "losses": losses,
            "passes_per_step": [query_step_passes(k, grouped, accum)
                                for k, _, _ in batches[1 + CLQA_TRAIN_WARM:]],
            "launches_as_schedule": launches_ok,
            "cpu_step": {"card_loss": card_loss, "cpu_loss": cpu_loss,
                         "loss_abs_err": abs(card_loss - cpu_loss), "worst": worst,
                         "value": ratio[worst], "median": statistics.median(ratio.values()),
                         "cpu_s": cpu_s}}
        all_ok &= (grads_ok and launches_ok and abs(card_loss - cpu_loss)
                   <= LOSS_RTOL * abs(cpu_loss) and bool(np.isfinite(losses).all()))

    # pretrain_queries over the repo's set and a generated member
    mix_root = base / "query_mix"
    shutil.copytree(ROOT / CLQA_ROOT / "FB15k-237-betae", mix_root / "FB15k-237-betae")
    t0 = time.perf_counter()
    write_betae_dataset(str(mix_root), **QUERY_MIX_MEMBER)
    gen_s = time.perf_counter() - t0
    mix_cfg = clqa_config(str(ckpt), epochs=1, bpe=QUERY_MIX_STEPS)
    mix_cfg["dataset"] = {"class": "JointQueryDataset", "root": str(mix_root),
                          "graphs": ["FB15k237", "NELL995"]}
    mix_cfg["train"]["fast_test"] = QUERY_MIX_FAST_TEST
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with LogLines() as log:
        mix_results = cli.run(mix_cfg, seed=0, device="cuda", workdir=str(base / "mixture"))
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    mix_counts = launch_counts()
    total = plus(total, mix_counts)
    runs["mixture"] = {"wall_s": mix_s, "generate_s": gen_s, "launches": as_json(mix_counts),
                       "log": [l for l in log if "step" in l or "valid" in l],
                       "results": {name: {k: m[k] for k in CLQA_METRICS}
                                   for name, m in mix_results.items()}}

    record = {"graph": {"V": v, "E": int(graph.csr.col.numel()), "R": r,
                        "rel_graph_E": int(graph.relation_graph.csr.col.numel())},
              "train_queries": int(tr_hi - tr_lo), "valid_queries": int(va_hi - va_lo),
              "planner_s": planner_s, "runs": runs, "steps": steps,
              "tolerance": f"loss rtol {LOSS_RTOL}; per tensor max|err| <= {GRAD_REL_TO_MAX} "
                           f"* max|grad_cpu| + {GRAD_ATOL}"}
    print("[clqa-training] " + json.dumps(record), flush=True)
    check(all_ok, "a step kind failed its CPU check or its launches: " + json.dumps(steps))
    check(len(mix_results) == 2 and all(
        np.isfinite(list(m.values())).all() and 0 < m["mrr"] <= 1
        for m in mix_results.values()), f"mixture test metrics {mix_results}")
    check(any("avg valid mrr" in l for l in log), "the mixture logged no validation")
    return record, total


def sum_serving(split, cfg):
    """The serving path at full width: ultra_3g, random weights from a seed,
    written in the reference .pth layout and served from it. Returns (the
    ``[serving]`` record, the launches of the precompute and the 4
    batches, E1's, E2's and S1's under their wrappers' names)."""
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
    dim = cfg.entity_model.input_dim
    # E2 ends each conv layer: a launch a layer of each pass, on the relation
    # graph's rows x 64 relations, the entity graph's x a batch; E1 none
    precompute_ends = layer_ends()
    want_precompute_ends = {"conv_epilogue": {},
                            "conv_tail": {(num_rel * PRECOMPUTE_CHUNK, dim): want_precompute},
                            "mlp_score": {}}

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
    serve_ends = layer_ends()
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
    timed_ends = layer_ends()
    # E2 ends each layer of a batch and S1 scores it: one launch a batch
    batch_ends = lambda batches: {
        "conv_epilogue": {}, "conv_tail": {(num_nodes * BATCH, dim): layers * batches},
        "mlp_score": {(num_nodes * BATCH, BATCH): batches}}
    want_serve_ends = batch_ends(TAIL_BATCHES + HEAD_BATCHES)
    want_timed_ends = batch_ends(TIMED_BATCHES)
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
                     "timed": timed_launches,
                     "layer_ends": {"precompute": as_json(precompute_ends),
                                    "serve": as_json(serve_ends),
                                    "timed": as_json(timed_ends)}},
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
    check(precompute_ends == want_precompute_ends,
          f"the precompute launched E1, E2 and S1 {precompute_ends}, want "
          f"{want_precompute_ends}")
    check((serve_ends, timed_ends) == (want_serve_ends, want_timed_ends),
          f"E1, E2 and S1 launched {serve_ends} in 4 batches and {timed_ends} in the timed "
          f"ones, want {want_serve_ends} and {want_timed_ends} (E2 6 a pass, S1 one)")
    check(ok_topk, "top-k disagrees with score_all, or scores are not finite")
    check(ok_cpu, f"card and CPU scores differ by up to {float(score_err.max())!r}")
    del pred, cpu_pred
    torch.cuda.empty_cache()
    counts = plus(precompute_counts, serve_counts)
    return serving, plus(counts, plus(precompute_ends, serve_ends))



# [distributed]: multi-process runs (parallel/, train/distributed.py). (a) A
# 1-rank group (nccl for the card's tensors, gloo for the host's) through
# train_distributed for DIST_TRAIN_STEPS steps of BATCH rows and
# evaluate_distributed of DIST_VALID triples, held against the same schedule
# in one process on the card (the same weights, batches and kernels: equal
# within LOSS_RTOL). (b) 2 ranks over gloo, both on the one card (nccl takes
# one rank a device), as subprocesses of this script: data=2 steps (4 rows a
# rank), edge=2 score and train steps for the sum model (BATCH rows) and for
# the PNA model (DIST_PNA_BATCH rows), and one data=2 grouped query step on
# [clqa-training]'s set, each held against the same global batch in this
# process on the card: the first step's loss within LOSS_RTOL and its
# gradients as [training]'s (the PNA step's: see summed_in_halves), the later
# losses within
# DIST_LATER_LOSS_RTOL (AdamW moves each weight by about lr whatever the
# size of its gradient, so a tiny gradient's rounding moves a weight), the
# scores within SCORE_RTOL/SCORE_ATOL; each rank's launches as the step's
# launches predict on its rows (a block keeps every node, so the keys are
# the whole graph's); gloo's MAX and MIN all-reduce of CUDA tensors checked
# against the host's answer first, and each rank's block of the edges, whose
# rows with no live edge B1 must write 0 and B3 -inf and +inf.
DIST_STEPS, DIST_TRAIN_STEPS, DIST_VALID, DIST_PNA_BATCH = 3, 4, 64, PNA_CHECK_BATCH
DIST_LATER_LOSS_RTOL, DIST_TIMEOUT_S = 1e-4, 300
# The PNA step's gradients are not a continuous function of the order of its
# sums: a min/max gradient goes whole to every edge that ties, and two
# messages equal in exact arithmetic tie in f32 or not as their sums were
# associated. Two ranks add each aggregate's halves apart, which moves the
# 6-layer step's gradients by a median of 0.027 of each tensor's largest
# entry from one process's (PERF.md). So the 2-rank PNA step is held to
# [training]'s per-tensor bound against the same step in this process with
# each aggregate over the entity graph summed in the same halves
# (summed_in_halves), and to its loss, its scores and MINMAX_GRAD_WORST on
# its worst tensor against the plain one-process step, whose median is
# reported beside that of a step from weights moved by one ulp.


def dist_batches(split, graph, n, batch, seed):
    """(the training graph's index, ``n`` (batch, easy-edge mask) pairs of
    ``batch`` rows drawn from ``seed``): the same in every process."""
    from ultra_tpu_torch import tasks
    from ultra_tpu_torch.train.runner import triples_of

    index = tasks.GraphIndex.build(split.edge_index, split.edge_type, split.num_nodes,
                                   split.num_relations)
    triples, rng, out = triples_of(split), np.random.default_rng(seed), []
    for _ in range(n):
        pos = triples[rng.choice(len(triples), batch, replace=False)]
        b = tasks.negative_sampling(index, pos, NUM_NEGATIVE, strict=True, rng=rng)
        out.append((b, tasks.easy_edge_weights(index, b, graph.num_edges_padded)))
    return index, out


def dist_inputs(split, graph, dataset, query_graph):
    """Every rank's and the reference's inputs: the sum steps' batches, the
    PNA step's, the (h, t, r) rows to score, and a query batch of BATCH
    training queries with its grouped dropout plan."""
    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.executor import (
        QueryConfig, projection_schedule, simulate_symbolic_grouped,
    )
    from ultra_tpu_torch.query.trainer import answers_to_mask, dropout_planner, graph_host

    _, batches = dist_batches(split, graph, DIST_STEPS, BATCH, seed=2)
    _, pna_batches = dist_batches(split, graph, 1, DIST_PNA_BATCH, seed=3)
    score = batches[0][0][:, 0].copy()
    (tr_lo, tr_hi), _, _ = dataset.split_ranges()
    take = np.random.default_rng(1).choice(np.arange(tr_lo, tr_hi), BATCH, replace=False)
    kind, operand = ops.decompose(dataset.queries[take])
    target = answers_to_mask([dataset.easy_answers[i] for i in take],
                             query_graph.num_nodes).astype(np.float32)
    host = graph_host(dataset.graphs[0], query_graph)
    qcfg = QueryConfig(logic="product", threshold=0.8, dropout_ratio=0.25)
    plan = simulate_symbolic_grouped(kind, operand, *projection_schedule(kind), host, qcfg,
                                     np.random.default_rng(4), dropout_planner(host, query_graph))
    return {"batches": batches, "pna_batches": pna_batches, "score": score,
            "query": (kind, operand, target, plan), "qcfg": qcfg}


def dist_query_set(device):
    """[clqa-training]'s dataset and its training query graph on ``device``."""
    from ultra_tpu_torch.query.datasets import build_query_dataset
    from ultra_tpu_torch.query.trainer import prepare_query_graph

    dataset = build_query_dataset("FB15k237LogicalQuery", str(ROOT / CLQA_ROOT)).load()
    return dataset, prepare_query_graph(dataset.graphs[0], device=device)


def score_launches(cfg, num_nodes, num_rel, batch):
    """Forward launches of a score step: both directions, each a pass of the
    relation and of the entity model."""
    feat = batch * cfg.entity_model.input_dim
    return times(plus(forward_launches(cfg.relation_model, num_rel, feat),
                      forward_launches(cfg.entity_model, num_nodes, feat)), 2)


def distributed_rank(rank, port, out, device="cuda"):
    """One of [distributed]'s two gloo ranks (``--distributed-rank``): each
    mode's losses, first gradients, scores, milliseconds a step, bytes and
    seconds of all-reduce a step and launches, saved to ``out``."""
    import torch.distributed as dist

    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.graph import resolve_device
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_fwd
    from ultra_tpu_torch.ops.rspmm_minmax_cuda import rspmm_minmax_fwd
    from ultra_tpu_torch.parallel import dp, multihost
    from ultra_tpu_torch.parallel.mesh import make_mesh, shard_graph
    from ultra_tpu_torch.query.executor import graphs_for_slots
    from ultra_tpu_torch.query.trainer import make_grouped_query_train_step
    from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params
    from ultra_tpu_torch.utils.benchlib import fb15k237_split, pna_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")  # one card for both
    device = resolve_device(multihost.rank_device(device))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    record = {"rank": rank, "backend": str(dist.get_backend()), "device": str(device)}

    # gloo's MAX and MIN of CUDA tensors, against the answer on the host
    probe = torch.arange(4.0, device=device) * (1 - 2 * rank) + rank
    got = {op: dp.all_reduce(probe.clone(), op, None).cpu().tolist() for op in ("max", "min")}
    want = {"max": [1.0, 1.0, 2.0, 3.0], "min": [0.0, 0.0, -1.0, -2.0]}
    record["minmax_probe"] = {"got": got, "ok": got == want,
                              "tensor_device": str(probe.device)}

    t0 = time.perf_counter()
    split = fb15k237_split("realistic", seed=0)
    graph = split_to_graph(split, device=device)
    dataset, query_graph = dist_query_set(device)
    inputs = dist_inputs(split, graph, dataset, query_graph)
    data_mesh, edge_mesh = make_mesh(data=2), make_mesh(data=1, edge=2)
    block = shard_graph(graph, edge_mesh)
    record["setup_s"] = time.perf_counter() - t0
    empty = block.csr.rowptr.diff() == 0
    gen = torch.Generator().manual_seed(rank)
    rel = torch.randn(graph.num_relations, 512, generator=gen).to(device)
    x = torch.randn(graph.num_nodes, 512, generator=gen).to(device)
    written = bool((rspmm_sum_fwd(block.csr, block.edge_weight, rel, x)[empty] == 0).all())
    for is_min, fill in ((False, float("-inf")), (True, float("inf"))):
        ext = rspmm_minmax_fwd(block.csr, block.edge_weight, rel, x, is_min=is_min)
        written &= bool((ext[empty] == fill).all() and torch.isfinite(ext[~empty]).all())
    record["block"] = {"live_edges": int(block.csr.col.numel()),
                       "padded_edges": block.num_edges_padded,
                       "empty_rows": int(empty.sum()), "empty_rows_written": written}
    v, r = graph.num_nodes, graph.num_relations

    total = [no_launches()]

    def counted():
        """This call's launches since the last reset, also added to the rank's total."""
        counts = launch_counts()
        total[0] = plus(total[0], counts)
        return counts

    def timed(run_step):
        """(loss, ms, bytes and ms of all-reduce) of one step, each
        all-reduce timed (the device synchronised around it)."""
        before = dict(dp.stats)
        sync()
        t1 = time.perf_counter()
        with dp.timed_collectives():
            loss = float(run_step())
        sync()
        return (loss, 1e3 * (time.perf_counter() - t1), dp.stats["bytes"] - before["bytes"],
                1e3 * (dp.stats["seconds"] - before["seconds"]))

    def record_mode(name, rows, stepped, launches_ok, grads, **extra):
        losses, lat, sent, coll = map(list, zip(*stepped))
        record[name] = dict(extra, rows=rows, losses=losses, step_ms=lat,
                            allreduce_bytes=sent, allreduce_ms=coll,
                            launches_ok=launches_ok, grads=grads)

    def steps(name, cfg, mesh, g_, batches, rows, score=False):
        model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device=device)
        state = init_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY)
        extra = {}
        if score:
            reset_launch_counts()
            t_pred, h_pred = dp.make_sharded_score_step(mesh)(model, g_, inputs["score"][:rows])
            sync()
            extra = dict(t_pred=t_pred.cpu(), h_pred=h_pred.cpu(),
                         score_launches_ok=counted() == score_launches(cfg, v, r, rows))
        step = dp.make_sharded_train_step(mesh, num_negative=NUM_NEGATIVE)
        want = per_step_launches(cfg, v, r, batch=rows)
        stepped, ok, grads = [], True, None
        for b, ew in batches:
            reset_launch_counts()
            stepped.append(timed(lambda: step(state, g_, b, ew)))
            ok &= counted() == want
            grads = grads or {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        record_mode(name, rows, stepped, ok, grads, **extra)

    cfg, pna = UltraConfig(), pna_config()
    for name, cfg_, mesh, g_, batches, rows, score in (
            ("data2", cfg, data_mesh, graph, inputs["batches"], BATCH // 2, False),
            ("edge2-sum", cfg, edge_mesh, block, inputs["batches"], BATCH, True),
            ("edge2-pna", pna, edge_mesh, block, inputs["pna_batches"], DIST_PNA_BATCH,
             True)):
        steps(name, cfg_, mesh, g_, batches, rows, score)

    kind, operand, target, plan = inputs["query"]
    rows = data_mesh.rows(len(kind))
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device=device)
    state = init_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY)
    step = make_grouped_query_train_step(inputs["qcfg"], 0.2, sync_grads=dp.grad_sync(data_mesh))
    reset_launch_counts()
    stepped = [timed(lambda: step(state, graphs_for_slots(query_graph, plan), kind[rows],
                                  operand[rows], target[rows]))]
    want = query_step_launches(cfg, kind[rows], True, 1, query_graph.num_nodes,
                               query_graph.num_relations)
    record_mode("query-data2", rows.stop - rows.start, stepped,
                without_zeros(counted()) == without_zeros(want),
                {k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    record["collectives"] = dict(dp.stats)
    record["launches"] = total[0]
    torch.save(record, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_command(rank, port, out):
    return [sys.executable, str(ROOT / "chip_smoke.py"), "--distributed-rank", str(rank),
            "--port", str(port), "--out", str(out)]


def grads_within(got, want, worst_only=False):
    """({tensor: max|err| / max|want|}, within [training]'s bound, or with
    ``worst_only`` the worst tensor within MINMAX_GRAD_WORST)."""
    ratio, ok = {}, True
    for k, w in want.items():
        err, scale = float((got[k] - w).abs().max()), float(w.abs().max())
        ok &= err <= GRAD_REL_TO_MAX * scale + GRAD_ATOL
        ratio[k] = err / max(scale, 1e-30)
    if worst_only:
        ok = max(ratio.values()) <= MINMAX_GRAD_WORST
    return ratio, ok


class _ExtremeOfHalves(torch.autograd.Function):
    """The max (or min) of two halves' partial extremes; the gradient goes
    whole to each half whose partial equals the result, as
    ``parallel/dp.py``'s combine routes it."""

    @staticmethod
    def forward(ctx, a, b, is_min):
        out = torch.minimum(a, b) if is_min else torch.maximum(a, b)
        ctx.save_for_backward(a == out, b == out)
        return out

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return *(torch.where(tie, g, zero) for tie in ctx.saved_tensors), None


@contextlib.contextmanager
def summed_in_halves(graph):
    """Within the block, every conv over ``graph`` (the entity graph; the
    relation graph stays whole) aggregates each of the two edge blocks of
    ``shard_graph`` apart, under the step's weights, and adds (or takes the
    extreme of) the two: one process associating each sum as two edge=2
    ranks do, kernel by kernel."""
    from ultra_tpu_torch.models import layers
    from ultra_tpu_torch.parallel.mesh import Mesh, shard_graph

    real = layers.rspmm_from_graph
    blocks = [(shard_graph(graph, Mesh(1, 2, 0, e)), Mesh(1, 2, 0, e).edge_block(
        graph.num_edges_padded)) for e in range(2)]

    def halves(g, relation, x, *, sum="add", mul="mul"):
        if g.num_nodes != graph.num_nodes:
            return real(g, relation, x, sum=sum, mul=mul)
        a, b = (real(block.replace_weights(g.edge_weight[sl]), relation, x, sum=sum, mul=mul)
                for block, sl in blocks)
        return a + b if sum == "add" else _ExtremeOfHalves.apply(a, b, sum == "min")

    layers.rspmm_from_graph = halves
    try:
        yield
    finally:
        layers.rspmm_from_graph = real


def distributed_run(cfg, pna_cfg, split, graph, device="cuda"):
    """[distributed] (see DIST_STEPS): part (a) in this process, part (b)'s
    two ranks as subprocesses, then the references on the card. Returns
    (the record, the launches of (a) and of both ranks)."""
    import torch.distributed as dist

    from ultra_tpu_torch import tasks
    from ultra_tpu_torch.models.nbfnet import ultra_score_all
    from ultra_tpu_torch.parallel import dp, multihost
    from ultra_tpu_torch.query.executor import graphs_for_slots
    from ultra_tpu_torch.query.trainer import make_grouped_query_train_step
    from ultra_tpu_torch.train import distributed
    from ultra_tpu_torch.train import eval as eval_lib
    from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params, make_train_step
    from ultra_tpu_torch.train.runner import triples_of

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    v, r = graph.num_nodes, graph.num_relations
    index = tasks.GraphIndex.build(split.edge_index, split.edge_type, v, r)
    triples = triples_of(split)
    record, total = {}, no_launches()

    # (a) one rank through train_distributed and evaluate_distributed
    multihost.initialize(f"localhost:{free_port()}", 1, 0,
                         backend="gloo" if device == "cpu" else None)
    backend = str(dist.get_backend())
    lat, losses, real = [], [], distributed.make_sharded_train_step

    def timed_factory(*a, **kw):
        step = real(*a, **kw)

        def timed(*args):
            sync()
            t0 = time.perf_counter()
            loss = step(*args)
            losses.append(float(loss))
            lat.append(1e3 * (time.perf_counter() - t0))
            return loss

        return timed

    distributed.make_sharded_train_step = timed_factory
    calls_before = dp.stats["calls"]
    try:
        model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device=device)
        reset_launch_counts()
        model = distributed.train_distributed(
            {"batch_size": BATCH, "num_epoch": 1, "batch_per_epoch": DIST_TRAIN_STEPS},
            {"num_negative": NUM_NEGATIVE, "strict_negative": True,
             "adversarial_temperature": 1.0}, model, graph, index, triples, seed=0, lr=LR)
        train_counts = launch_counts()
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = distributed.evaluate_distributed(model, graph, triples[:DIST_VALID], index,
                                                   batch_size=BATCH, metrics=LP_METRICS)
        eval_s = time.perf_counter() - t0
        eval_counts = launch_counts()
    finally:
        distributed.make_sharded_train_step = real
        dist.destroy_process_group()
    collective_calls = dp.stats["calls"] - calls_before
    total = plus(plus(total, train_counts), eval_counts)
    del model

    # the same schedule in one process: the rank's stream, shard and steps
    ref = init_ultra_params(cfg, torch.Generator().manual_seed(0), device=device)
    state = init_train_state(ref, lr=LR, weight_decay=WEIGHT_DECAY)
    step = make_train_step(adversarial_temperature=1.0, num_negative=NUM_NEGATIVE)
    rng, perm = np.random.default_rng(0), multihost.shard_indices(len(triples), 0, seed=0)
    ref_losses, ref_lat = [], []
    for s in range(DIST_TRAIN_STEPS):
        batch = tasks.negative_sampling(index, triples[perm[s * BATCH:(s + 1) * BATCH]],
                                        NUM_NEGATIVE, strict=True, rng=rng)
        ew = tasks.easy_edge_weights(index, batch, graph.num_edges_padded)
        sync()
        t0 = time.perf_counter()
        ref_losses.append(float(step(state, graph, on(batch), on(ew))))
        ref_lat.append(1e3 * (time.perf_counter() - t0))
    ref_metrics = eval_lib.evaluate(ref, graph, triples[:DIST_VALID], index, batch_size=BATCH,
                                    metrics=LP_METRICS)
    del ref, state
    record["one_rank"] = {
        "backend": backend, "steps": DIST_TRAIN_STEPS, "losses": losses,
        "reference_losses": ref_losses, "step_ms": lat, "reference_step_ms": ref_lat,
        "step_ms_median": statistics.median(lat),
        "reference_step_ms_median": statistics.median(ref_lat),
        "valid_triples": DIST_VALID, "metrics": metrics, "reference_metrics": ref_metrics,
        "evaluate_s": eval_s, "allreduce_calls": collective_calls}
    one_ok = (all(abs(a - b) <= LOSS_RTOL * abs(b) for a, b in zip(losses, ref_losses))
              and len(losses) == DIST_TRAIN_STEPS
              and all(abs(metrics[k] - ref_metrics[k]) <= LOSS_RTOL * abs(ref_metrics[k])
                      for k in LP_METRICS)
              and train_counts == times(per_step_launches(cfg, v, r), DIST_TRAIN_STEPS)
              and eval_counts == validation_launches(cfg, v, r, DIST_VALID)
              and (device == "cpu" or "nccl" in backend) and collective_calls == DIST_TRAIN_STEPS)

    # (b) two gloo ranks on the one card, as subprocesses
    out = ROOT / "build" / "chip_smoke" / "distributed"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    port = free_port()
    logs = [open(out / f"rank{k}.log", "w") for k in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(rank_command(k, port, out), cwd=ROOT, stdout=logs[k],
                              stderr=subprocess.STDOUT) for k in range(2)]
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, DIST_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    ranks_s = time.perf_counter() - t0
    for k, proc in enumerate(procs):
        if proc.returncode != 0:
            print((out / f"rank{k}.log").read_text()[-4000:], file=sys.stderr, flush=True)
        check(proc.returncode == 0, f"rank {k} of 2 exited with {proc.returncode} after "
                                    f"{ranks_s:.1f} s (timeout {DIST_TIMEOUT_S} s)")
    ranks = [torch.load(out / f"rank{k}.pt", weights_only=False) for k in range(2)]
    for rec in ranks:
        total = plus(total, rec["launches"])

    # the references: each mode's global batch in this process
    dataset, query_graph = dist_query_set(device)
    inputs = dist_inputs(split, graph, dataset, query_graph)

    def reference(cfg_, batches, rows):
        model = init_ultra_params(cfg_, torch.Generator().manual_seed(0), device=device)
        with torch.no_grad():
            b = on(inputs["score"][:rows])
            t_pred = ultra_score_all(model, graph, b[:, 0], r_index=b[:, 2]).cpu()
            h_pred = ultra_score_all(model, graph, b[:, 1], r_index=b[:, 2] + r // 2,
                                     query_r_index=b[:, 2]).cpu()
        state = init_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY)
        step = make_train_step(adversarial_temperature=1.0, num_negative=NUM_NEGATIVE)
        ref_losses, grads = [], None
        for b, ew in batches:
            ref_losses.append(float(step(state, graph, on(b), on(ew))))
            grads = grads or {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        return {"losses": ref_losses, "grads": grads, "t_pred": t_pred, "h_pred": h_pred}

    refs = {"data2": reference(cfg, inputs["batches"], BATCH)}
    refs["edge2-sum"] = refs["data2"]
    refs["edge2-pna"] = reference(pna_cfg, inputs["pna_batches"], DIST_PNA_BATCH)
    with summed_in_halves(graph):
        halves = reference(pna_cfg, inputs["pna_batches"], DIST_PNA_BATCH)
    # the PNA step from weights moved by one ulp: how far rounding alone moves it
    model = moved_by_one_ulp(init_ultra_params(pna_cfg, torch.Generator().manual_seed(0),
                                               device=device))
    b, ew = inputs["pna_batches"][0]
    make_train_step(num_negative=NUM_NEGATIVE)(
        init_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY), graph, on(b), on(ew))
    ulp_ratio, _ = grads_within({k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                                refs["edge2-pna"]["grads"])
    ulp_median = statistics.median(ulp_ratio.values())
    del model
    kind, operand, target, plan = inputs["query"]
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device=device)
    state = init_train_state(model, lr=LR, weight_decay=WEIGHT_DECAY)
    loss = make_grouped_query_train_step(inputs["qcfg"], 0.2)(
        state, graphs_for_slots(query_graph, plan), kind, operand, target)
    refs["query-data2"] = {"losses": [float(loss)], "grads": {
        k: p.grad.detach().cpu() for k, p in model.named_parameters()}}
    del model, state

    ok, modes = one_ok, {}
    for name, ref_ in refs.items():
        for rec in ranks:
            m = rec[name]
            ratio, grads_ok = grads_within(m["grads"], ref_["grads"], name == "edge2-pna")
            loss_ok = abs(m["losses"][0] - ref_["losses"][0]) <= LOSS_RTOL * abs(ref_["losses"][0])
            later_ok = all(abs(a - b) <= DIST_LATER_LOSS_RTOL * abs(b)
                           for a, b in zip(m["losses"][1:], ref_["losses"][1:]))
            score_err = None
            if "t_pred" in m:
                err = torch.cat([(m["t_pred"] - ref_["t_pred"]).abs()
                                 - SCORE_RTOL * ref_["t_pred"].abs(),
                                 (m["h_pred"] - ref_["h_pred"]).abs()
                                 - SCORE_RTOL * ref_["h_pred"].abs()])
                score_err = float(err.max())
                ok &= score_err <= SCORE_ATOL and m["score_launches_ok"]
            ok &= (grads_ok and loss_ok and later_ok and m["launches_ok"]
                   and len(m["losses"]) == len(ref_["losses"]))
            worst, extra = max(ratio, key=ratio.get), {}
            if name == "edge2-pna":  # the per-tensor bound, against the same association
                h_ratio, h_ok = grads_within(m["grads"], halves["grads"])
                h_loss = abs(m["losses"][0] - halves["losses"][0])
                ok &= h_ok and h_loss <= LOSS_RTOL * abs(halves["losses"][0])
                h_worst = max(h_ratio, key=h_ratio.get)
                extra = {"summed_in_halves": {
                    "loss": halves["losses"][0], "loss_err": h_loss, "grad_err_over_max": {
                        "worst": h_worst, "value": h_ratio[h_worst],
                        "median": statistics.median(h_ratio.values())}}}
            modes.setdefault(name, []).append({**extra,
                "rows_per_rank": m["rows"], "losses": m["losses"],
                "reference_losses": ref_["losses"], "step_ms": m["step_ms"],
                "allreduce_mib_per_step": [b / 2**20 for b in m["allreduce_bytes"]],
                "allreduce_ms_per_step": m["allreduce_ms"],
                "grad_err_over_max": {"worst": worst, "value": ratio[worst],
                                      "median": statistics.median(ratio.values())},
                "score_err_past_rtol": score_err, "launches_as_predicted": m["launches_ok"]})
        ok &= ranks[0][name]["losses"] == ranks[1][name]["losses"]
    live = sum(rec["block"]["live_edges"] for rec in ranks)
    ok &= live == int(graph.csr.col.numel()) and all(
        rec["minmax_probe"]["ok"] and rec["block"]["empty_rows_written"] for rec in ranks)
    record["two_ranks"] = {
        "backend": ranks[0]["backend"], "devices": [rec["device"] for rec in ranks],
        "wall_s": ranks_s, "setup_s": [rec["setup_s"] for rec in ranks],
        "blocks": [rec["block"] for rec in ranks], "gloo_minmax_on_cuda_tensors":
            [rec["minmax_probe"] for rec in ranks], "pna_ulp_control_median": ulp_median,
        "modes": modes}
    record["tolerance"] = (
        f"loss rtol {LOSS_RTOL} (later steps {DIST_LATER_LOSS_RTOL}); first step's gradients "
        f"per tensor max|err| <= {GRAD_REL_TO_MAX} * max|ref| + {GRAD_ATOL} (the PNA step: "
        f"so against one process summing in the ranks' halves, and its worst tensor <= "
        f"{MINMAX_GRAD_WORST} against the plain one); scores rtol {SCORE_RTOL} atol "
        f"{SCORE_ATOL}; metrics rtol {LOSS_RTOL}")
    print("[distributed] " + json.dumps(record), flush=True)
    check(one_ok, "the 1-rank group's run differs from one process's, or its launches or "
                  "backend are not as predicted (see [distributed] one_rank)")
    check(ok, "a rank of the 2-rank group differs from one process, or its launches, its "
              "blocks or gloo's min/max probe are wrong (see [distributed] two_ranks)")
    return record, total



# [tooling]: the modules the port took over last. The native join of the
# graph of relations (ultra_tpu_torch/native) against the numpy join
# (tasks.relation_graph_arrays_numpy), element for element and in order, on
# bench.py's FB15k-237-shaped graph, the three rule-KGs of PRETRAIN_MEMBERS
# and [clqa]'s query graph, with and without a live mask dropping
# NATIVE_DROP of the edges, each timed on the host (median of NATIVE_RUNS).
# The ragged-set ops (ops/variadic.py) and spmm_max on CUDA tensors against
# the same ops on the CPU, on VARIADIC_SETS sets of up to V = 14,541
# elements (two empty, ties): integers and indices equal, a max, min, sort
# or top-k equal, arithmetic in f64 within VARIADIC_RTOL of the CPU's.
# utils/profiling.py: a trace of one ultra_3g serving batch (its B1 kernel
# events against the launch counter, its annotation), and StepTimer over
# TIMER_BATCHES synchronised batches within TIMER_RTOL of their CUDA events.
# The parity command lines in this process, against [link-prediction]'s
# zero-shot and [clqa]'s test metrics from the same .pth files. The
# supervisor (scripts/torch_supervise.py): its probe up on the card and
# down under CUDA_VISIBLE_DEVICES="" within PROBE_DOWN_TIMEOUT, and
# scripts/torch_run.py fine-tuning SUPERVISED_STEPS steps on
# [link-prediction]'s dataset with a crash checkpoint every SUPERVISED_EVERY
# steps, its child killed once the checkpoint appears, resumed, rc 0.
NATIVE_DROP, NATIVE_RUNS = 0.25, 3
VARIADIC_SETS, VARIADIC_RTOL = 8, 1e-6
TIMER_BATCHES, TIMER_RTOL = 10, 0.10
SUPERVISED_STEPS, SUPERVISED_EVERY, PROBE_DOWN_TIMEOUT = 24, 4, 60


def cpu_model():
    """The host CPU's model name, else its vendor, family and model numbers
    (/proc/cpuinfo), else the machine's architecture."""
    import platform

    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    if fields.get("model name", "unknown") != "unknown":
        return fields["model name"]
    parts = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
             if fields.get(k, "unknown") != "unknown"]
    return ", ".join(parts) or platform.machine()


def native_join_run(graphs):
    """{graph: {masked: (numpy ms, native ms, edges)}} of the two joins,
    each held equal, dtype, element and order."""
    from ultra_tpu_torch import native, tasks

    check(native.available(), "the native join did not build or no g++ was found")
    record = {}
    for name, (ei, et, v, r) in graphs.items():
        live = np.random.default_rng(0).random(ei.shape[1]) >= NATIVE_DROP
        for masked in (False, True):
            args = (ei, et, v, r, live if masked else None)
            ms = {}
            for join, fn in (("numpy", tasks.relation_graph_arrays_numpy),
                             ("native", native.relgraph_build_native)):
                runs = []
                for _ in range(NATIVE_RUNS):
                    t0 = time.perf_counter()
                    out = fn(*args)
                    runs.append(1e3 * (time.perf_counter() - t0))
                ms[join], ms[join + "_out"] = statistics.median(runs), out
            equal = all(a.dtype == b.dtype == np.int64 and np.array_equal(a, b)
                        for a, b in zip(ms["native_out"], ms["numpy_out"]))
            check(equal, f"{name} (live mask {masked}): the native join differs from numpy's")
            record[f"{name}{'/live' if masked else ''}"] = {
                "numpy_ms": ms["numpy"], "native_ms": ms["native"],
                "ratio": ms["numpy"] / ms["native"], "edges": int(ei.shape[1]),
                "relation_graph_edges": int(ms["numpy_out"][1].size)}
    return record


def ragged_inputs(split):
    """The [tooling] inputs of the ragged ops: VARIADIC_SETS set sizes up to
    V (one of V, two empty), values of each kind, in-set targets."""
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, split.num_nodes + 1, VARIADIC_SETS)
    sizes[[1, 5]], sizes[3] = 0, split.num_nodes
    total = int(sizes.sum())
    return rng, torch.from_numpy(sizes), {
        "f64": torch.from_numpy(rng.normal(size=total)),
        "ties": torch.from_numpy(rng.integers(0, 50, total).astype(np.float32)),
        "int": torch.from_numpy(rng.integers(-1000, 1000, total).astype(np.int32))}


def card_vs_cpu(fn, *args):
    """``fn`` on CUDA copies of ``args`` against ``fn`` on them on the CPU:
    (exact, max relative error of the floats)."""
    card, cpu = fn(*(a.cuda() for a in args)), fn(*args)
    card = card if isinstance(card, tuple) else (card,)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    exact, worst = True, 0.0
    for c, p in zip(card, cpu):
        c = c.cpu()
        check(c.shape == p.shape and c.dtype == p.dtype,
              f"card {c.dtype}{tuple(c.shape)} against CPU {p.dtype}{tuple(p.shape)}")
        exact &= torch.equal(c, p)
        if p.is_floating_point():
            finite = torch.isfinite(p)
            check(torch.equal(c[~finite], p[~finite]), "non-finite values differ")
            err = ((c - p).abs() / p.abs())[finite & (p != 0)]
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
            check(torch.equal(c[p == 0], p[p == 0]), "a zero differs")
    return exact, worst


def ragged_ops_run(split, graph):
    """Each op of ops/variadic.py and spmm_max on the card against the CPU;
    returns {op: max relative error}."""
    from ultra_tpu_torch.ops import spmm_max
    from ultra_tpu_torch.ops import variadic as V

    rng, sizes, values = ragged_inputs(split)
    starts = torch.cumsum(sizes, 0) - sizes
    record = {}

    def hold(name, fn, *args, exact=True):
        is_exact, worst = card_vs_cpu(fn, *args)
        record[name] = worst
        check(is_exact if exact else worst <= VARIADIC_RTOL,
              f"{name} on the card differs from the CPU (max relative error {worst!r})")

    hold("size_to_index", V.size_to_index, sizes)
    hold("variadic_arange", V.variadic_arange, sizes)
    for kind, value in values.items():
        for op in ("variadic_max", "variadic_min"):
            hold(f"{op}/{kind}", getattr(V, op), value, sizes)
        for descending in (False, True):
            hold(f"variadic_sort/{kind}/{descending}",
                 lambda v, s, d=descending: V.variadic_sort(v, s, descending=d), value, sizes)
        for k, largest in ((5, True), (5, False), (int(sizes.max()) + 3, True)):
            hold(f"variadic_topk/{kind}/{k}/{largest}",
                 lambda v, s, k=k, lg=largest: V.variadic_topk(v, s, k, largest=lg),
                 value, sizes)
        arithmetic = value.double() if kind == "ties" else value
        for op in ("variadic_sum", "variadic_mean"):
            hold(f"{op}/{kind}", getattr(V, op), arithmetic, sizes,
                 exact=kind == "int" and op == "variadic_sum")
        if kind != "int":
            for op in ("variadic_softmax", "variadic_log_softmax"):
                hold(f"{op}/{kind}", getattr(V, op), arithmetic, sizes, exact=False)
    full = sizes[sizes > 0]
    target = torch.from_numpy(rng.integers(0, full.numpy()))
    hold("variadic_cross_entropy", V.variadic_cross_entropy,
         torch.from_numpy(rng.normal(size=int(full.sum()))), target, full, exact=False)
    hold("multi_slice_mask", lambda s, e: V.multi_slice_mask(s, e, int(sizes.sum())),
         starts, starts + sizes // 2)
    table = torch.from_numpy(rng.normal(size=(split.num_nodes, 8)))
    mask = torch.from_numpy(rng.random((split.num_nodes, 8)) < 0.5)
    for axis in (None, 0, 1):
        hold(f"masked_mean/{axis}", lambda v, m, a=axis: V.masked_mean(v, m, a), table, mask,
             exact=False)
        hold(f"mean_with_nan/{axis}", lambda v, a=axis: V.mean_with_nan(v, a),
             torch.where(mask, table, float("nan")), exact=False)
    other = torch.from_numpy(rng.permutation(sizes.numpy()))
    hold("variadic_extend", V.variadic_extend, values["f64"], sizes,
         torch.from_numpy(rng.normal(size=int(other.sum()))), other)
    # spmm_max over the entity graph's edges: rows without an edge, 0 values
    ei = torch.from_numpy(np.asarray(split.edge_index))
    value = torch.from_numpy(rng.normal(size=ei.shape[1]).astype(np.float32))
    value[::10] = 0.0
    for width in (8, None):
        matrix = torch.from_numpy(rng.normal(
            size=(split.num_nodes, width) if width else split.num_nodes).astype(np.float32))
        hold(f"spmm_max/{width or '1-D'}",
             lambda e, v, m: spmm_max(e, v, graph.num_nodes, graph.num_nodes, m),
             ei, value, matrix)
    return record


def profiling_run(split, cfg):
    """utils/profiling.py on one ultra_3g serving batch on the
    FB15k-237-shaped graph (served as [serving] serves it): ``trace`` holds
    one B1 kernel event for each launch the counter saw and the
    ``annotate`` region; then StepTimer over TIMER_BATCHES batches
    synchronised on their scores, against CUDA events around the same
    batches. Returns (record, the traced batch's launches)."""
    from ultra_tpu_torch.models.nbfnet import entity_nbfnet_score_all
    from ultra_tpu_torch.train.loop import init_ultra_params
    from ultra_tpu_torch.utils.profiling import StepTimer, annotate, trace

    base = ROOT / "build" / "chip_smoke" / "tooling"
    ckpt = base / "ultra_3g_seed0.pth"
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.save({"model": model.state_dict()}, ckpt)
    pred = serve(split, ckpt, "cuda")
    rng = np.random.default_rng(1)
    h = rng.integers(0, split.num_nodes, BATCH)
    r = rng.integers(0, split.num_relations // 2, BATCH)
    pred.predict_tails(h, r, k=TOPK)  # warm
    logdir = base / "trace"
    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    region = "tooling/serving_batch"
    with trace(str(logdir)):
        with annotate(region):
            pred.predict_tails(h, r, k=TOPK)
        torch.cuda.synchronize()
    counts = launch_counts()
    files = sorted(logdir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"trace wrote {files}, want one Chrome trace")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")
    b1_events = sum(n for name, n in kernels.items()
                    if all(part in name for part in ("piece_kernel", "Gather", "Sum")))
    b1_launches = sum(counts["rspmm_sum_fwd"].values()) + sum(counts["rspmm_sum_dx"].values())
    record = {"trace": str(files[0].relative_to(ROOT)), "trace_bytes": files[0].stat().st_size,
              "b1_kernel_events": b1_events, "b1_launches": b1_launches,
              "kernel_events": sum(kernels.values()),
              "top_kernels": dict(kernels.most_common(6)),
              "annotation": any(e.get("name") == region for e in events)}

    timer = StepTimer(window=TIMER_BATCHES, edges_per_step=int(pred.graph.csr.col.numel()))
    hb, rb = torch.as_tensor(h, device=pred.device), torch.as_tensor(r, device=pred.device)
    events_ms, enqueue_ms = [], []
    with torch.no_grad():
        for _ in range(TIMER_BATCHES):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            timer.start()
            t0 = time.perf_counter()
            start.record()
            scores = entity_nbfnet_score_all(pred.model.entity_model, pred.graph,
                                             pred.rel_reprs[rb], hb, rb)
            end.record()
            enqueue_ms.append(1e3 * (time.perf_counter() - t0))
            timer.stop(sync=scores)
            events_ms.append(start.elapsed_time(end))
    record.update(step_timer_ms=1e3 * timer.mean_step_s, cuda_events_ms=statistics.mean(events_ms),
                  host_enqueue_ms=statistics.mean(enqueue_ms), step_timer=timer.summary())
    record["timer_gap"] = abs(record["step_timer_ms"] / record["cuda_events_ms"] - 1)
    check(b1_events == b1_launches == len(pred.model.entity_model.layers),
          f"the trace holds {b1_events} B1 kernel events, the counter {b1_launches} launches, "
          f"want one a layer: {dict(kernels)}")
    check(record["annotation"], f"the trace lacks the {region!r} region")
    check(record["timer_gap"] <= TIMER_RTOL,
          f"StepTimer read {record['step_timer_ms']!r} ms a batch, CUDA events "
          f"{record['cuda_events_ms']!r}")
    return record, counts


def run_main(script, args, workdir):
    """``scripts/<script>.py``'s ``main`` in this process, with ``args`` as
    its command line, from ``workdir``; returns its last line as JSON."""
    import io

    module = load_script(script)
    out, argv = io.StringIO(), sys.argv
    workdir.mkdir(parents=True, exist_ok=True)
    sys.argv = [f"{script}.py", *args]
    try:
        with contextlib.chdir(workdir), contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = argv
    return json.loads(out.getvalue().strip().splitlines()[-1])


def parity_runs(cfg, lp_root, records, clqa_dataset, clqa_graph):
    """The two parity command lines in this process, from [link-prediction]'s
    and [clqa]'s ``.pth`` files, each timed with its launches read around
    it: their rows against those phases' zero-shot test metrics (the
    scripts round to 4 digits) and their launches against those phases'
    evaluations of the same splits. Returns (record, launches)."""
    base = ROOT / "build" / "chip_smoke" / "tooling"
    lp_test = records["link-prediction"]["zero_shot"]["results"]["test"]
    clqa_test = records["clqa"]["results"]["test"]
    runs = {
        "parity_run": (
            ["-d", "FBIngram:synth", "--ckpt", str(lp_root.parent / "ultra_3g_seed0.pth"),
             "--root", str(lp_root)],
            {"mrr": lp_test["mrr"], "hits@10": lp_test["hits@10"]},
            records["link-prediction"]["zero_shot"]["launches"]),
        "parity_run_query": (
            ["-d", "FB15k237LogicalQuery", "--root", str(ROOT / CLQA_ROOT), "--ckpt",
             str(ROOT / "build" / "chip_smoke" / "clqa" / "ultraquery_seed0.pth"), "--bs",
             str(BATCH)],
            {"epfo_mrr": clqa_test["[EPFO] mrr"], "epfo_hits@10": clqa_test["[EPFO] hits@10"],
             "neg_mrr": clqa_test["[negation] mrr"],
             "neg_hits@10": clqa_test["[negation] hits@10"]},
            as_json(clqa_launches(cfg, clqa_dataset, clqa_graph, splits=(2,))[0])),
    }
    record, total = {}, no_launches()
    for script, (args, want, want_launches) in runs.items():
        shutil.rmtree(base / script, ignore_errors=True)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        report = run_main(f"torch_{script}", args, base / script)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        total = plus(total, counts)
        record[script] = {"wall_s": wall_s, "rows": report["rows"],
                          "b1_launches": fwd_launches(counts), "launches": as_json(counts)}
        check(len(report["rows"]) == 1 and "error" not in report["rows"][0],
              f"torch_{script}.py reported {report['rows']}")
        row = report["rows"][0]
        check(all(row[k] == round(v, 4) for k, v in want.items()),
              f"torch_{script}.py row {row}, want the phase's {want}")
        check(as_json(counts) == want_launches,
              f"torch_{script}.py launched {as_json(counts)}, want {want_launches}")
    return record, total


def proc_children(pid):
    """The pids whose parent is ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:  # ended meanwhile
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(entry))
    return out


def supervise_start(lp_root):
    """Starts the supervisor three times: around ``python -c pass`` (its
    probe must pass), the same with no card visible (it must give up), and
    around scripts/torch_run.py fine-tuning on [link-prediction]'s dataset
    with a crash checkpoint every SUPERVISED_EVERY steps (``--no-probe``:
    the probe is held by the first two, and two more of its processes would
    double the run's time). Returns
    {name: (Popen, its workdir, its stdout and stderr paths, start)}."""
    base = ROOT / "build" / "chip_smoke" / "tooling" / "supervise"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    yaml_text = (ROOT / "config" / "inductive" / "inference.yaml").read_text()
    patched = yaml_text.replace("  root: ./kg-datasets/\n", f"  root: {lp_root}\n").replace(
        "train:\n", f"train:\n  checkpoint_interval_steps: {SUPERVISED_EVERY}\n")
    check(patched.count(str(lp_root)) == 1 and "checkpoint_interval_steps" in patched,
          "config/inductive/inference.yaml no longer has the lines [tooling] edits")
    (base / "supervised.yaml").write_text(patched)
    supervise = [sys.executable, str(ROOT / "scripts" / "torch_supervise.py")]
    env = dict(os.environ, SUPERVISE_MAX_BACKOFF="0")
    runs = {
        "probe_up": (["--backend-max-wait", "0", "--probe-timeout", "120", "--",
                      sys.executable, "-c", "pass"], env),
        "probe_down": (["--backend-max-wait", "0", "--probe-timeout", str(PROBE_DOWN_TIMEOUT),
                        "--", sys.executable, "-c", "pass"], dict(env, CUDA_VISIBLE_DEVICES="")),
        "fine_tune": (["--max-restarts", "2", "--no-probe", "--",
                       sys.executable, str(ROOT / "scripts" / "torch_run.py"), "-c",
                       str(base / "supervised.yaml"), "--dataset", "FBIngram", "--version",
                       "synth", "--epochs", "1", "--bpe", str(SUPERVISED_STEPS), "--ckpt",
                       str(lp_root.parent / "ultra_3g_seed0.pth")], env),
    }
    procs = {}
    for name, (args, run_env) in runs.items():
        work = base / name
        out, err = base / f"{name}.out", base / f"{name}.err"
        with open(out, "w") as fo, open(err, "w") as fe:
            procs[name] = (subprocess.Popen([*supervise, "--workdir", str(work), *args],
                                            env=run_env, stdout=fo, stderr=fe, cwd=base,
                                            start_new_session=True),
                           work, out, err, time.perf_counter())
    return procs


def kill_child_once(procs):
    """Kills the fine-tuning supervisor's child (not the supervisor) once
    its crash checkpoint appears; returns (pid, the checkpoint's step)."""
    import signal

    sup, work, _, _, _ = procs["fine_tune"]
    ckpt = work / "model_latest.pth"
    deadline = time.monotonic() + 300
    while not ckpt.exists():
        check(sup.poll() is None and time.monotonic() < deadline,
              f"the supervisor ended (rc {sup.poll()}) or timed out before {ckpt} appeared")
        time.sleep(0.01)
    children = proc_children(sup.pid)
    check(len(children) == 1, f"the supervisor has children {children}, want its command")
    os.kill(children[0], signal.SIGKILL)
    return children[0], int(torch.load(ckpt, map_location="cpu", weights_only=True)["step"])


def supervise_finish(procs, killed):
    """Waits for the three supervisors and holds each to its outcome."""
    record, outs = {}, {}
    for name, (proc, work, out, err, start) in procs.items():
        rc = proc.wait(timeout=600)
        record[name] = {"rc": rc, "wall_s": time.perf_counter() - start}
        outs[name] = (out.read_text(), err.read_text())
    down_err = outs["probe_down"][1]
    check(record["probe_up"]["rc"] == 0,
          f"the probe reported the card down: {outs['probe_up'][1][-2000:]}")
    check(record["probe_down"]["rc"] == 75 and "backend never came up" in down_err
          and record["probe_down"]["wall_s"] < PROBE_DOWN_TIMEOUT,
          f"with no card visible the supervisor exited {record['probe_down']['rc']} after "
          f"{record['probe_down']['wall_s']:.1f} s: {down_err[-2000:]}")
    work = procs["fine_tune"][1]
    out, err = outs["fine_tune"]
    pid, step_at_kill = killed
    after = err.split("restart 1:", 1)[1] if "restart 1:" in err else ""
    resume_line = next((line for line in err.splitlines() if "restart 1:" in line), None)
    resumed = [line for line in after.splitlines() if "resumed train state from" in line]
    epochs = [line for line in after.splitlines() if "avg bce" in line]
    final_step = int(torch.load(work / "model_latest.pth", map_location="cpu",
                                weights_only=True)["step"])
    record["fine_tune"].update(
        killed_pid=pid, step_at_kill=step_at_kill, final_step=final_step,
        steps_after_restart=final_step - step_at_kill, resume_line=resume_line,
        runner_resume=resumed[:1], epoch_after_restart=epochs[-1:],
        results=next((line for line in out.splitlines() if line.startswith("{'valid'")), None))
    check(record["fine_tune"]["rc"] == 0, f"the supervised run exited "
                                          f"{record['fine_tune']['rc']}: {err[-3000:]}")
    check(resume_line is not None and str(work / "model_latest.pth") in resume_line
          and len(resumed) == 1 and "restart 2:" not in err,
          f"the run did not resume once from its crash checkpoint: {err[-3000:]}")
    check(final_step - step_at_kill == SUPERVISED_STEPS and len(epochs) == 1
          and f"{SUPERVISED_STEPS} steps" in epochs[0],
          f"resumed at step {step_at_kill}, ended at {final_step}, epochs {epochs}")
    return record


def tooling_run(split, graph, cfg, lp_root, records, clqa_dataset, clqa_graph):
    """[tooling] (see NATIVE_DROP): the native join first (timed on an idle
    host), then the supervisors start in the background while this process
    holds the ragged ops, profiling and the parity command lines. Returns
    (the ``[tooling]`` record, the launches of the traced batch and the
    parity runs)."""
    from ultra_tpu_torch.data import kg

    t0 = time.perf_counter()
    graphs = {"fb15k237": (split.edge_index, split.edge_type, split.num_nodes,
                           split.num_relations)}
    for keys in PRETRAIN_MEMBERS:
        keys = dict(keys)
        train = kg.build_dataset(keys.pop("class"), str(ROOT / "kg-datasets"), **keys).load().train
        graphs[f"rule-kg-v{keys['num_nodes']}"] = (train.edge_index, train.edge_type,
                                                   train.num_nodes, train.num_relations)
    qg = clqa_dataset.graphs[2]
    graphs["query"] = (qg.edge_index, qg.edge_type, qg.num_nodes, qg.num_relations)
    record = {"host": {"cpu": cpu_model(), "nproc": os.cpu_count(),
                       "affinity": len(os.sched_getaffinity(0))},
              "native_join": native_join_run(graphs)}
    for name, row in record["native_join"].items():
        print(f"[tooling] join {name}: numpy {row['numpy_ms']:.2f} ms, native "
              f"{row['native_ms']:.2f} ms, ratio {row['ratio']:.2f} ({row['edges']} edges, "
              f"{row['relation_graph_edges']} relation-graph edges; {record['host']['cpu']}, "
              f"{record['host']['nproc']} CPUs)", flush=True)

    import signal
    from concurrent.futures import ThreadPoolExecutor

    procs = supervise_start(lp_root)
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        killed = pool.submit(kill_child_once, procs)
        record["ragged_ops_max_rel_err"] = ragged_ops_run(split, graph)
        record["profiling"], counts = profiling_run(split, cfg)
        record["parity"], parity_counts = parity_runs(cfg, lp_root, records, clqa_dataset,
                                                      clqa_graph)
        record["supervise"] = supervise_finish(procs, killed.result(timeout=600))
    finally:
        # each supervisor leads its own process group, its commands with it
        for proc, *_ in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        pool.shutdown()
    record["wall_s"] = time.perf_counter() - t0
    print("[tooling] " + json.dumps(record), flush=True)
    for name, row in record["parity"].items():
        print(f"[tooling] torch_{name}.py: {row['wall_s']:.2f} s, {row['b1_launches']} B1 "
              f"launches, row {row['rows'][0]}", flush=True)
    sup = record["supervise"]["fine_tune"]
    print(f"[tooling] supervised torch_run.py: {sup['resume_line']} | "
          f"{sup['runner_resume']} | resumed at step {sup['step_at_kill']}, "
          f"{sup['steps_after_restart']} steps after the restart, rc {sup['rc']}, "
          f"{sup['wall_s']:.1f} s", flush=True)
    prof = record["profiling"]
    print(f"[tooling] profiling: {prof['b1_kernel_events']} B1 kernel events for "
          f"{prof['b1_launches']} launches; StepTimer {prof['step_timer_ms']:.3f} ms a batch, "
          f"CUDA events {prof['cuda_events_ms']:.3f} ms, host enqueue "
          f"{prof['host_enqueue_ms']:.3f} ms", flush=True)
    return record, plus(counts, parity_counts)


def bf16_config(cfg):
    """``cfg`` with ``compute_dtype: bfloat16`` in both models."""
    return dataclasses.replace(
        cfg, relation_model=dataclasses.replace(cfg.relation_model, compute_dtype="bfloat16"),
        entity_model=dataclasses.replace(cfg.entity_model, compute_dtype="bfloat16"))


def as_bf16(counts):
    """Launch counts predicted for an f32 model as a bf16 model's: each key
    with its wrapper's bf16 instance (BF16_INSTANCES)."""
    return {name: {tuple(shape) + (BF16_INSTANCES[name],): n for shape, n in by_shape.items()}
            for name, by_shape in counts.items()}


def f32_launches(counts):
    """The launches of ``counts`` that went to an f32 instance: none may in a
    bf16 model's run."""
    return {name: n for name, by_shape in counts.items() for shape, n in by_shape.items()
            if not isinstance(shape[-1], str)}


def bf16_kernels(graph, cfg, gen):
    """The bf16 instances of B1-B6 against their plain versions in f64 on the
    same bf16 operands, at the main path's shapes: B1 on the entity graph at
    F=512 and on the relation graph at F=512 and 4096 (the precompute), B1
    on the source-major CSR and B2 on both graphs at F=512, B3, B4 and B5 on
    the entity graph at F=512, B6 at attribution's F=64 and a batch's
    F=512 (which puts K > 1 units of 8 features on a lane of its 8-feature
    pass); each timed beside its plain version and the f32 instance
    (``f32_ms``, ``f32_ratio``, ``f32_equal``). Returns ({row name: row},
    ok)."""
    from ultra_tpu_torch.ops import rspmm_cuda as k

    fwd_src, drel_src = (f"ultra_tpu_torch/csrc/{n}.cu" for n in KERNELS[:2])
    dim = cfg.entity_model.input_dim
    feat = BATCH * dim
    rows, ok = {}, True
    for tag, g_, fwd_feats, fwd_replaces, drel_replaces in (
        ("entity", graph, (feat,), "ultra_tpu/ops/rspmm_pallas_v2.py:508",
         "ultra_tpu/ops/rspmm_pallas_v2.py:1054"),
        ("relation", graph.relation_graph, (feat, PRECOMPUTE_CHUNK * dim),
         "ultra_tpu/ops/rspmm_pallas.py:283", "ultra_tpu/ops/rspmm_pallas.py:381"),
    ):
        w = (g_.edge_weight.cpu() * (torch.rand(g_.edge_weight.shape, generator=gen) >= 0.1))
        w = w.cuda()
        rand = lambda *shape, dtype=torch.bfloat16: torch.randn(
            *shape, generator=gen).to(dtype).cuda()
        cases = [(f"rspmm_sum_fwd[bf16]/{tag}/F{f}", fwd_src, fwd_replaces, k.rspmm_sum_fwd,
                  k.rspmm_sum_fwd_plain, g_.csr, rand(g_.num_relations, f), rand(g_.num_nodes, f),
                  rspmm_bound_ms) for f in fwd_feats]
        cases += [
            (f"rspmm_sum_dx[bf16]/{tag}/F{feat}", fwd_src, fwd_replaces, k.rspmm_sum_dx,
             k.rspmm_sum_dx_plain, g_.csr_src, rand(g_.num_relations, feat),
             rand(g_.num_nodes, feat, dtype=torch.float32), rspmm_bound_ms),
            (f"rspmm_sum_drel[bf16]/{tag}/F{feat}", drel_src, drel_replaces, k.rspmm_sum_drel,
             k.rspmm_sum_drel_plain, g_.segments, rand(g_.num_nodes, feat),
             rand(g_.num_nodes, feat, dtype=torch.float32), drel_bound_ms)]
        for name, source, replaces, kernel, plain, layout, a, b, bound in cases:
            case_rows, case_ok = hold(name, source, {"mul": replaces}, kernel, plain, layout,
                                      w, a, b, bound)
            rows.update((row["name"], row) for row in case_rows)
            ok &= case_ok
    minmax_rows, minmax_ok = hold_minmax(
        "entity", graph, feat, gen,
        {"fwd": "ultra_tpu/ops/rspmm_pallas_v2.py:704",
         "dx": "ultra_tpu/ops/rspmm_pallas_v2.py:927",
         "drel": "ultra_tpu/ops/rspmm_pallas_v2.py:982"}, dtype=torch.bfloat16)
    dw_rows, dw_ok = hold_dw(graph, gen, "entity", (dim, feat), dtype=torch.bfloat16)
    rows.update(minmax_rows)
    rows.update(dw_rows)
    return rows, ok and minmax_ok and dw_ok


def grad_ratios(got, want):
    """{tensor: max|got - want| / max|want|} over two dicts of gradients."""
    return {k: float((got[k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for k, w in want.items()}


def timed_blocks(runs, n):
    """Each of ``runs`` ({name: fn}) ``n`` times a block, the blocks in the
    order a, b, b, a (two names), each ending in a synchronize: ({name: ms of
    each call}, {name: the block's largest device memory above what was
    allocated before it, MiB}, {name: calls a second})."""
    (a, fa), (b, fb) = runs.items()
    lat, work, busy = {a: [], b: []}, {a: 0.0, b: 0.0}, {a: 0.0, b: 0.0}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_block = time.perf_counter()
        for i in range(n):
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            lat[name].append(1e3 * (time.perf_counter() - t0))
        busy[name] += time.perf_counter() - t_block
        work[name] = max(work[name], (torch.cuda.max_memory_allocated() - base) / 2**20)
    return lat, work, {name: len(lat[name]) / busy[name] for name in lat}


def bf16_serving(split, cfg, cfg16):
    """ultra_3g served in f32 and in bf16 through
    ``UltraPredictor.from_checkpoint`` from one ``.pth`` of seed-0 weights:
    each precompute's launches and resident memory, TIMED_BATCHES batches of
    tail requests each (the same batches, timed in blocks f32, bf16, bf16,
    f32), the scores of one batch and its top 10. Returns (record, the bf16
    launches, ok)."""
    from ultra_tpu_torch.serve import UltraPredictor
    from ultra_tpu_torch.train.loop import init_ultra_params

    num_nodes, num_rel = split.num_nodes, split.num_relations
    dim = cfg.entity_model.input_dim
    ckpt = ROOT / "build" / "chip_smoke" / "ultra_3g_seed0.pth"
    model = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.save({"model": model.state_dict()}, ckpt)
    preds, resident, counts = {}, {}, {}
    for name, c in (("f32", cfg), ("bf16", cfg16)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        reset_launch_counts()
        preds[name] = UltraPredictor.from_checkpoint(str(ckpt), split, cfg=c, device="cuda",
                                                     batch_size=BATCH)
        torch.cuda.synchronize()
        resident[name] = (torch.cuda.memory_allocated() - before) / 2**20
        counts[name] = launch_counts()
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, num_nodes, BATCH), rng.integers(0, num_rel // 2, BATCH))
               for _ in range(TIMED_BATCHES)]
    top = {name: pred.predict_tails(*batches[0], k=TOPK) for name, pred in preds.items()}
    reset_launch_counts()
    lat, work, per_s = timed_blocks(
        {name: (lambda i, p=pred: p.predict_tails(*batches[i], k=TOPK))
         for name, pred in preds.items()}, TIMED_BATCHES // 2)
    timed_counts = launch_counts()
    scores = {name: pred.score_all(*batches[0]) for name, pred in preds.items()}
    del preds
    torch.cuda.empty_cache()

    err = float(np.abs(scores["bf16"] - scores["f32"]).max())
    scale = float(np.abs(scores["f32"]).max())
    overlap = float(np.mean([len(set(a) & set(b)) / TOPK
                             for a, b in zip(top["f32"][1], top["bf16"][1])]))
    per_batch = forward_launches(cfg.entity_model, num_nodes, BATCH * dim)
    want_precompute = times(forward_launches(cfg.relation_model, num_rel,
                                             PRECOMPUTE_CHUNK * dim),
                            -(-num_rel // PRECOMPUTE_CHUNK))
    want_timed = plus(times(per_batch, TIMED_BATCHES), as_bf16(times(per_batch, TIMED_BATCHES)))
    record = {
        name: {"batch_ms_median": statistics.median(lat[name]), "batch_ms_min": min(lat[name]),
               "batch_ms_max": max(lat[name]), "requests_per_s": BATCH * per_s[name],
               "resident_mib": resident[name], "batch_working_mib": work[name],
               "peak_mib": resident[name] + work[name]}
        for name in ("f32", "bf16")}
    record.update({"max_abs_score_diff": err, "max_abs_score_f32": scale,
                   "score_bound": BF16_REL * scale, "top10_overlap": overlap,
                   "launches": {"bf16_precompute": as_json(counts["bf16"]),
                                "timed": as_json(timed_counts)}})
    ok = err <= BF16_REL * scale
    ok &= counts["f32"] == want_precompute and counts["bf16"] == as_bf16(want_precompute)
    ok &= timed_counts == want_timed
    ok &= bool(all(np.isfinite(s).all() for s in scores.values()))
    return record, plus(counts["bf16"], as_bf16(times(per_batch, TIMED_BATCHES))), ok


@contextlib.contextmanager
def plain_rspmm():
    """The rspmm's autograd Functions (``ops/rspmm.py``) on the kernels'
    plain PyTorch versions, whatever the device: a reference that rounds
    the operands as the kernels do and sums in f32 in other orders. Nothing
    is counted as a launch."""
    from ultra_tpu_torch.ops import rspmm, rspmm_cuda, rspmm_minmax_cuda

    names = ("rspmm_sum_fwd", "rspmm_sum_dx", "rspmm_sum_drel", "rspmm_dw",
             "rspmm_minmax_fwd", "rspmm_minmax_dx", "rspmm_minmax_drel")
    saved = {name: getattr(rspmm, name) for name in names}
    try:
        for name in names:
            module = rspmm_minmax_cuda if name.startswith("rspmm_minmax") else rspmm_cuda
            setattr(rspmm, name, getattr(module, f"{name}_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(rspmm, name, fn)


def bf16_training(split, graph, cfg, cfg16, n_steps, rows=BATCH, plain=False):
    """One step of ``cfg`` and of ``cfg16`` from the same seed-0 weights on
    the same batch of ``rows`` rows (loss and gradients), and with ``plain``
    the ``cfg16`` step again on the plain versions (:func:`plain_rspmm`);
    then ``n_steps`` more of each of the first two, timed in blocks f32,
    bf16, bf16, f32, with their launches. Returns (record, the bf16 steps'
    launches, {run: {tensor: gradient}})."""
    from ultra_tpu_torch.models.nbfnet import Ultra
    from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params, make_train_step

    _, batches = dist_batches(split, graph, 1 + n_steps // 2, rows, seed=1)
    on_card = [tuple(torch.as_tensor(a, device="cuda") for a in b) for b in batches]
    init = init_ultra_params(cfg, torch.Generator().manual_seed(0), device="cpu").state_dict()
    step = make_train_step(adversarial_temperature=1.0, num_negative=NUM_NEGATIVE)
    states, losses, grads, first = {}, {}, {}, {}
    runs = [("f32", cfg), ("bf16", cfg16)] + ([("bf16_plain", cfg16)] if plain else [])
    for name, c in runs:
        model = Ultra(c)
        model.load_state_dict(init)
        states[name] = init_train_state(model.cuda(), lr=LR, weight_decay=WEIGHT_DECAY)
        reset_launch_counts()
        with plain_rspmm() if name == "bf16_plain" else contextlib.nullcontext():
            losses[name] = float(step(states[name], graph, *on_card[0]))
        torch.cuda.synchronize()
        first[name] = launch_counts()
        grads[name] = {k: p.grad.detach().clone() for k, p in states[name].model.named_parameters()}
    states.pop("bf16_plain", None)
    want = per_step_launches(cfg, graph.num_nodes, graph.num_relations, batch=rows)
    record = {"rows": rows, "loss": losses,
              "launches_first_step": {k: as_json(first[k]) for k in ("f32", "bf16")},
              "launches_ok": first["f32"] == want and first["bf16"] == as_bf16(want)}
    bf16_counts = first["bf16"]
    if n_steps:
        reset_launch_counts()
        lat, work, per_s = timed_blocks(
            {name: (lambda i, st=st: step(st, graph, *on_card[1 + i]))
             for name, st in states.items()}, n_steps // 2)
        timed_counts = launch_counts()
        n = 2 * (n_steps // 2)
        record["launches_ok"] &= timed_counts == plus(times(want, n), as_bf16(times(want, n)))
        bf16_counts = plus(bf16_counts, as_bf16(times(want, n)))
        record.update({name: {"step_ms_median": statistics.median(lat[name]),
                              "step_ms_min": min(lat[name]), "step_ms_max": max(lat[name]),
                              "steps_per_s": per_s[name], "step_working_mib": work[name]}
                       for name in lat})
        record["launches_timed"] = as_json(timed_counts)
    return record, bf16_counts, grads


def bf16_attribution(split, graph, cfg, cfg16):
    """``edge_gradients`` of one target triple (as ``[visualize]`` picks
    them) in f32 and in bf16 from the same seed-0 weights: the call's ms and
    launches, and per layer max|err| over the live edges against the f32
    call's largest |gradient|. Returns (record, the bf16 launches, ok)."""
    from ultra_tpu_torch.models.visualize import edge_gradients
    from ultra_tpu_torch.train.loop import init_ultra_params

    i = int(np.random.default_rng(4).choice(split.target_edge_index.shape[1], 1)[0])
    query = (int(split.target_edge_index[0, i]), int(split.target_edge_index[1, i]),
             int(split.target_edge_type[i]))
    live = (graph.edge_weight != 0).cpu().numpy()
    grads, ms, counts = {}, {}, {}
    for name, c in (("f32", cfg), ("bf16", cfg16)):
        model = init_ultra_params(c, torch.Generator().manual_seed(0), device="cuda")
        edge_gradients(model, graph, *query)  # warm-up
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads[name] = edge_gradients(model, graph, *query)  # copies to the host
        ms[name] = 1e3 * (time.perf_counter() - t0)
        counts[name] = launch_counts()
    ratios = [float(np.abs(b - a)[live].max() / max(np.abs(a[live]).max(), 1e-30))
              for a, b in zip(grads["f32"], grads["bf16"])]
    want = attribution_launches(cfg, graph.num_nodes, split.num_relations)
    record = {"query": query, "ms": ms, "layer_err_over_max": ratios,
              "launches": as_json(counts["bf16"])}
    ok = max(ratios) <= BF16_GRAD_WORST and statistics.median(ratios) <= BF16_REL
    ok &= counts["f32"] == want and counts["bf16"] == as_bf16(want)
    return record, counts["bf16"], ok


def bf16_clqa(cfg, cfg16, dataset, graph):
    """One batch of BATCH test queries (the first of each of as many
    types) answered by UltraQuery of seed-0 weights in f32 and in bf16
    (``query/trainer.py::make_query_forward_grouped``, after the relation
    precompute): the logits' largest difference against 3 * BF16_REL of the
    largest |logit|, and the bf16 launches: the precompute and the entity
    model once a round of the batch's projection schedule. Returns (record,
    the bf16 launches, ok)."""
    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.executor import QueryConfig, projection_schedule
    from ultra_tpu_torch.query.trainer import make_query_forward_grouped
    from ultra_tpu_torch.train.eval import precompute_relation_representations
    from ultra_tpu_torch.train.loop import init_ultra_params

    lo, hi = dataset.split_ranges()[2]
    types = [t for t in range(len(dataset.id2type)) if (dataset.types[lo:hi] == t).any()]
    types = types[:BATCH]
    picked = np.array([lo + np.nonzero(dataset.types[lo:hi] == t)[0][0] for t in types])
    kind, operand = ops.decompose(dataset.queries[picked])
    qcfg = QueryConfig(logic="product", dropout_ratio=0.0, threshold=0.8)
    logits, counts = {}, {}
    for name, c in (("f32", cfg), ("bf16", cfg16)):
        model = init_ultra_params(c, torch.Generator().manual_seed(0), device="cuda").eval()
        reset_launch_counts()
        rel_reprs = precompute_relation_representations(model, graph)
        logits[name] = make_query_forward_grouped(model, qcfg)(graph, kind, operand,
                                                               rel_reprs).cpu().numpy()
        counts[name] = launch_counts()
    rounds = projection_schedule(np.asarray(kind))[3]
    dim = cfg.entity_model.input_dim
    want = plus(times(forward_launches(cfg.relation_model, graph.num_relations,
                                       PRECOMPUTE_CHUNK * dim),
                      -(-graph.num_relations // PRECOMPUTE_CHUNK)),
                times(forward_launches(cfg.entity_model, graph.num_nodes, BATCH * dim), rounds))
    err = float(np.abs(logits["bf16"] - logits["f32"]).max())
    scale = float(np.abs(logits["f32"]).max())
    prob = lambda a: 1.0 / (1.0 + np.exp(-a.astype(np.float64)))
    record = {"queries": len(picked), "types": [dataset.id2type[t] for t in types],
              "rounds": rounds, "max_abs_logit_diff": err, "max_abs_logit_f32": scale,
              "logit_bound": 3 * BF16_REL * scale,
              "max_abs_prob_diff": float(np.abs(prob(logits["bf16"]) - prob(logits["f32"])).max()),
              "launches": as_json(counts["bf16"])}
    ok = err <= 3 * BF16_REL * scale and bool(np.isfinite(logits["bf16"]).all())
    ok &= counts["f32"] == want and counts["bf16"] == as_bf16(want)
    return record, counts["bf16"], ok


def bf16_conv(graph, num_rel):
    """A bf16 conv (distmult, sum, F=512 on the entity graph) on the card
    against the same conv on the CPU, forward, within SCORE_RTOL/SCORE_ATOL:
    both round the same operands to bf16 and sum in f32, in other orders.
    Returns (record, ok)."""
    from ultra_tpu_torch.models.layers import ConvConfig, GeneralizedRelationalConv

    gen = torch.Generator().manual_seed(3)
    x, boundary = (torch.randn(graph.num_nodes, BATCH, 64, generator=gen) for _ in range(2))
    query = torch.randn(BATCH, 64, generator=gen)
    torch.manual_seed(0)
    conv = GeneralizedRelationalConv(ConvConfig(num_relation=num_rel, compute_dtype="bfloat16"))
    reset_launch_counts()
    with torch.no_grad():
        got = copy.deepcopy(conv).cuda()(graph, x.cuda(), boundary.cuda(), query.cuda()).cpu()
        counts = {k: v for k, v in launch_counts().items() if v}
        expect = conv(graph.to("cpu"), x, boundary, query)
    err = (got - expect).abs()
    ok = bool(torch.isfinite(got).all() and (err <= SCORE_ATOL + SCORE_RTOL * expect.abs()).all())
    want = {"rspmm_sum_fwd": {(graph.num_nodes, BATCH * 64, "bf16_bf16"): 1}}
    return {"max_abs_err": float(err.max()), "launches": as_json(counts)}, ok and counts == want


def bf16_run(split, graph, cfg, pna_cfg, clqa_dataset, clqa_graph):
    """The ``[bf16]`` phase's main path (kernels apart): ultra_3g serving and
    fine-tuning, the PNA model's serving batch and step, attribution, a CLQA
    batch and the card-against-CPU conv, each bf16 against f32 (see
    BF16_REL). Prints the ``[bf16]`` record, then checks. Returns the bf16
    runs' launches."""
    cfg16, pna16 = bf16_config(cfg), bf16_config(pna_cfg)
    record, ok, counts = {}, {}, {}
    record["serving"], counts["serving"], ok["serving"] = bf16_serving(split, cfg, cfg16)

    train, counts["training"], grads = bf16_training(split, graph, cfg, cfg16, TIMED_STEPS)
    ratio = grad_ratios(grads["bf16"], grads["f32"])
    worst = max(ratio, key=ratio.get)
    train["grad_err_over_max"] = {"worst": worst, "value": ratio[worst],
                                  "median": statistics.median(ratio.values())}
    ok["training"] = (ratio[worst] <= BF16_GRAD_WORST
                      and statistics.median(ratio.values()) <= BF16_REL
                      and abs(train["loss"]["bf16"] - train["loss"]["f32"])
                      <= BF16_REL * abs(train["loss"]["f32"])
                      and train["launches_ok"])
    record["training"] = train

    from ultra_tpu_torch.models.nbfnet import ultra_score_all
    from ultra_tpu_torch.train.loop import init_ultra_params

    h, r = (torch.as_tensor(np.random.default_rng(2).integers(0, n, BATCH), device="cuda")
            for n in (split.num_nodes, split.num_relations // 2))
    scores, pna_counts = {}, {}
    for name, c in (("f32", pna_cfg), ("bf16", pna16)):
        reset_launch_counts()
        with torch.no_grad():
            model = init_ultra_params(c, torch.Generator().manual_seed(0), device="cuda")
            scores[name] = ultra_score_all(model, graph, h, r_index=r).cpu()
        pna_counts[name] = launch_counts()
    pna_err = float((scores["bf16"] - scores["f32"]).abs().max())
    pna_scale = float(scores["f32"].abs().max())
    pna_step, pna_step_counts, grads = bf16_training(split, graph, pna_cfg, pna16, 0,
                                                     plain=True)
    cosine = {k: float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30))
              for k, (a, b) in ((k, (grads["f32"][k], g)) for k, g in grads["bf16"].items())}
    ratio = grad_ratios(grads["bf16"], grads["f32"])
    plain_ratio = grad_ratios(grads["bf16"], grads["bf16_plain"])
    loss = pna_step["loss"]
    record["pna"] = {"max_abs_score_diff": pna_err, "max_abs_score_f32": pna_scale,
                     "score_bound": BF16_REL * pna_scale, "step": pna_step,
                     "vs_f32": {"grad_cosine_median": statistics.median(cosine.values()),
                                "grad_cosine_min": min(cosine.values()),
                                "grad_err_over_max_median": statistics.median(ratio.values()),
                                "grad_err_over_max_worst": max(ratio.values())},
                     "vs_plain": {"grad_err_over_max_median":
                                  statistics.median(plain_ratio.values()),
                                  "grad_err_over_max_worst": max(plain_ratio.values())}}
    pna_want = plus(forward_launches(pna_cfg.relation_model, split.num_relations,
                                     BATCH * pna_cfg.entity_model.input_dim),
                    forward_launches(pna_cfg.entity_model, split.num_nodes,
                                     BATCH * pna_cfg.entity_model.input_dim))
    ok["pna"] = (pna_err <= BF16_REL * pna_scale
                 and abs(loss["bf16"] - loss["f32"]) <= BF16_REL * abs(loss["f32"])
                 and abs(loss["bf16"] - loss["bf16_plain"])
                 <= BF16_PNA_LOSS_RTOL * abs(loss["bf16_plain"])
                 and statistics.median(plain_ratio.values()) <= BF16_REL
                 and max(plain_ratio.values()) <= BF16_GRAD_WORST
                 and pna_counts["bf16"] == as_bf16(pna_want) and pna_counts["f32"] == pna_want
                 and pna_step["launches_ok"])
    counts["pna"] = plus(pna_counts["bf16"], pna_step_counts)

    record["attribution"], counts["attribution"], ok["attribution"] = bf16_attribution(
        split, graph, cfg, cfg16)
    record["clqa"], counts["clqa"], ok["clqa"] = bf16_clqa(cfg, cfg16, clqa_dataset, clqa_graph)
    record["conv"], ok["conv"] = bf16_conv(graph, split.num_relations)
    total = no_launches()
    for c in counts.values():
        total = plus(total, c)
    record["f32_instance_launches"] = f32_launches(total)
    record["ok"] = ok
    print("[bf16] " + json.dumps(record), flush=True)
    check(all(ok.values()), f"[bf16] failed: {[k for k, v in ok.items() if not v]}")
    check(not record["f32_instance_launches"],
          f"a bf16 model launched f32 instances: {record['f32_instance_launches']}")
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)}")
    # [distributed]'s ranks: this script run again, once for each
    parser.add_argument("--distributed-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        parser.error(f"unknown phase in {phases}")
    if "tooling" in phases and not {"link-prediction", "clqa"} <= set(phases):
        parser.error("tooling holds the parity command lines to link-prediction and clqa: "
                     "run those phases too")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if args.distributed_rank is not None:
        return distributed_rank(args.distributed_rank, args.port, args.out)

    from ultra_tpu_torch.data import kg
    from ultra_tpu_torch.data.kg import split_to_graph
    from ultra_tpu_torch.graph import ROW_PIECE
    from ultra_tpu_torch.models.nbfnet import UltraConfig
    from ultra_tpu_torch.ops import build
    from ultra_tpu_torch.train.runner import prepare_graph
    from ultra_tpu_torch.utils.benchlib import (
        fb15k237_split, pna_config, uniform_destination_graph,
    )

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"cpus {len(os.sched_getaffinity(0))} torch_threads {torch.get_num_threads()}",
          flush=True)

    t0 = time.perf_counter()
    logs = build.build_all(KERNELS)
    for name in KERNELS:
        build.load(name)
        for usage in build.ptxas_usage(logs.get(name, "")):
            print(f"[build] {name}: {usage}", flush=True)
    # the bf16 instances of B1-B6: their passes on the 8-feature walk
    walk8 = [usage for name in KERNELS[:6] for usage in build.ptxas_usage(logs.get(name, ""))
             if any(policy in usage for policy in ("Gather8", "Drel8", "Dx8", "dw8_kernel"))]
    print("[build] 8-feature walk (rspmm_sum_fwd_bf16_bf16, rspmm_sum_fwd_bf16_f32, "
          "rspmm_sum_drel_bf16, rspmm_minmax_fwd_bf16_bf16, rspmm_minmax_dx_bf16_bf16, "
          "rspmm_minmax_drel_bf16_bf16, rspmm_dw_bf16_bf16): "
          + (" | ".join(walk8) or "built before this run"), flush=True)
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
          f"relation graph: V={rel_graph.num_nodes} E={rel_graph.csr.col.numel()}; "
          f"ROW_PIECE {ROW_PIECE}: {graph.csr.piece_row.numel()} pieces, "
          f"{graph.csr.long_rows.numel()} long rows ({graph.csr_src.piece_row.numel()} and "
          f"{graph.csr_src.long_rows.numel()} by source; relation graph "
          f"{rel_graph.csr.piece_row.numel()} and {rel_graph.csr.long_rows.numel()}); "
          f"type segments in {graph.segments.piece_row.numel()} pieces of "
          f"{graph.segments.piece_len} edges (relation graph "
          f"{rel_graph.segments.piece_row.numel()} of {rel_graph.segments.piece_len}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    (ROOT / "build" / "chip_smoke").mkdir(parents=True, exist_ok=True)
    if {"kernels", "visualize"} & set(phases):
        t0 = time.perf_counter()
        rule_dataset, rule_graph = rule_kg("cuda")
        print(f"[graph] rule-KG V={rule_graph.num_nodes} E={rule_graph.csr.col.numel()} "
              f"R={rule_graph.num_relations} relation graph: "
              f"V={rule_graph.relation_graph.num_nodes} "
              f"E={rule_graph.relation_graph.csr.col.numel()} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    if {"kernels", "link-prediction"} & set(phases):
        # written and processed once: [kernels] checks on its inference
        # graph, and [link-prediction]'s runs read its cache
        t0 = time.perf_counter()
        lp_root = write_lp_dataset()
        lp_dataset = kg.build_dataset("FBIngram", str(lp_root), version="synth").load()
        lp_graph = prepare_graph(lp_dataset.test, device="cuda")
        print(f"[graph] link-prediction inference graph V={lp_graph.num_nodes} "
              f"E={lp_graph.csr.col.numel()} R={lp_graph.num_relations} relation graph: "
              f"V={lp_graph.relation_graph.num_nodes} "
              f"E={lp_graph.relation_graph.csr.col.numel()} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    member_graphs = query_train_graph = None
    if {"kernels", "pretrain"} & set(phases):
        # [kernels] checks B1 and B2 at the members' training shapes, [pretrain] trains on them
        t0 = time.perf_counter()
        from ultra_tpu_torch.train.pretrain import PretrainGraphs

        member_graphs = PretrainGraphs(
            kg.JointDataset(str(ROOT / "kg-datasets"), PRETRAIN_MEMBERS).load(), device="cuda")
        print("[graph] pretraining members " + ", ".join(
            f"{d.name}: V={g.num_nodes} E={g.csr.col.numel()} R={g.num_relations} relation "
            f"graph E={g.relation_graph.csr.col.numel()}"
            for d, g in zip(member_graphs.datasets, member_graphs.train_graphs))
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    if {"kernels", "clqa", "clqa-training", "bf16"} & set(phases):
        # [kernels] checks B1 on the query graph, [clqa] and [bf16] answer on it
        t0 = time.perf_counter()
        from ultra_tpu_torch.query.datasets import build_query_dataset
        from ultra_tpu_torch.query.trainer import prepare_query_graph

        clqa_dataset = build_query_dataset("FB15k237LogicalQuery", str(ROOT / CLQA_ROOT)).load()
        clqa_graph = prepare_query_graph(clqa_dataset.graphs[2], device="cuda")
        print(f"[graph] query graph V={clqa_graph.num_nodes} E={clqa_graph.csr.col.numel()} "
              f"R={clqa_graph.num_relations} relation graph: "
              f"V={clqa_graph.relation_graph.num_nodes} "
              f"E={clqa_graph.relation_graph.csr.col.numel()}; queries "
              f"{clqa_dataset.num_samples} ({time.perf_counter() - t0:.1f} s)", flush=True)
        query_train_graph = prepare_query_graph(clqa_dataset.graphs[0], device="cuda")

    cfg, pna_cfg = UltraConfig(), pna_config()  # ultra_3g, and its PNA variant
    kernels, phase_counts, records, failures = {}, {}, {}, []

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
        t0 = time.perf_counter()
        uniform = uniform_destination_graph(split)
        print(f"[graph] uniform destinations: max in-degree "
              f"{int(uniform.csr.rowptr.diff().max())} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        rows, ok = check_kernels(graph, rule_graph, lp_graph, clqa_graph, cfg,
                                 torch.Generator().manual_seed(0), uniform,
                                 training_shapes(cfg, member_graphs.train_graphs,
                                                 query_train_graph))
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
                                                           "pna-training", PNA_CHECK_BATCH)
        check(not tf32_ok, "the TF32 control passed the PNA card-vs-CPU gradient check")

    run("kernels", kernel_phase)
    run("serving", serving_phase)
    run("training", training_phase)
    run("pna-serving", pna_serving_phase)
    run("pna-training", pna_training_phase)

    def conv_phase():
        rows, ok = conv_tail_rows(cfg.entity_model.input_dim)
        kernels.update(rows)
        check(ok, "E2 disagrees with its plain twin or launched other than once (see the "
                  "[kernel] lines)")
        conv_checks(graph, num_rel)

    run("conv", conv_phase)

    def bf16_phase():
        rows, ok = bf16_kernels(graph, cfg, torch.Generator().manual_seed(0))
        kernels.update(rows)
        check(ok, "a bf16 kernel instance disagrees with its plain version (see the [kernel] "
                  "lines)")
        phase_counts["bf16"] = bf16_run(split, graph, cfg, pna_cfg, clqa_dataset, clqa_graph)

    run("bf16", bf16_phase)

    def visualize_phase():
        _, phase_counts["visualize"] = visualize_run(split, graph, cfg, rule_dataset)

    def gather_probe_phase():
        rows, phase_counts["gather-probe"] = gather_probe_run(graph)
        kernels.update(rows)

    def link_prediction_phase():
        records["link-prediction"], phase_counts["link-prediction"] = link_prediction_run(
            cfg, lp_root, lp_dataset)

    def clqa_phase():
        records["clqa"], phase_counts["clqa"] = clqa_run(cfg, clqa_dataset, clqa_graph, smi)

    def pretrain_phase():
        _, phase_counts["pretrain"] = pretrain_run(cfg, member_graphs)

    def clqa_training_phase():
        _, phase_counts["clqa-training"] = clqa_training_run(cfg, clqa_dataset)

    def distributed_phase():
        _, phase_counts["distributed"] = distributed_run(cfg, pna_cfg, split, graph)

    def tooling_phase():
        check({"link-prediction", "clqa"} <= set(records),
              "[link-prediction] or [clqa] failed: the parity command lines have no reference")
        _, phase_counts["tooling"] = tooling_run(split, graph, cfg, lp_root, records,
                                                 clqa_dataset, clqa_graph)

    run("visualize", visualize_phase)
    run("link-prediction", link_prediction_phase)
    run("clqa", clqa_phase)
    run("pretrain", pretrain_phase)
    run("clqa-training", clqa_training_phase)
    run("distributed", distributed_phase)
    run("gather-probe", gather_probe_phase)
    run("tooling", tooling_phase)
    run("boundary-rows", lambda: boundary_rows_run(cfg))

    def scorer_phase():
        rows, ok = scorer_rows()
        kernels.update(rows)
        check(ok, "S1 disagrees with its plain twin, launched other than once, or is slower "
                  "than it should be at the ranking cell's shape (see the [kernel] lines)")

    run("scorer", scorer_phase)
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
    # PNA model, attribution, link prediction, complex queries, the
    # multi-process runs (whose blocks of edges keep every node, so their
    # keys are the whole graph's) and the gather probe
    for name, row in kernels.items():
        wrapper, shape = name.split("/")[0].split("[")[0], tuple(row["launch_key"])
        row["launches_by_phase"] = {phase: counts.get(wrapper, {}).get(shape, 0)
                                    for phase, counts in phase_counts.items()
                                    if phase in row.get("phases", phase_counts)}
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
