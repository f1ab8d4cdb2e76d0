"""One rank of the port's multi-process modes for ``test_torch_parallel.py``:
torch and the port only, on the CPU, in a gloo process group of WORLD ranks
(no group at 1). It reads the inputs the test wrote to DIR, runs every mode
in turn and saves what it computed to DIR/rank<RANK>_of<WORLD>.pt:

    python tests/torch_parallel_worker.py RANK WORLD PORT DIR

At WORLD 2 the rank joins its first group from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
which the test sets), and after the modes below a second one, at
``localhost:PORT``, from ``ULTRA_DIST`` as ``scripts/torch_run.py`` reads it.

Modes (the global batch and masks come from the test):
- ``dp``, ``dp_accum2``: data=WORLD train steps, grad_accum 1 and 2;
- ``per_rank``: data=WORLD with per-rank easy-edge masks;
- ``edge_sum``, ``edge_pna``: edge=WORLD score and train steps;
- ``naive``: ``edge_sum``'s train step with the combine replaced by
  ``torch.distributed.nn``'s autograd all-reduce, whose backward sums the
  already whole gradient again (the control of the edge-gradient check);
- ``trainer``: ``train_distributed`` and then ``evaluate_distributed`` on an
  odd number of triples;
- ``query_per_slot``, ``query_grouped``, ``query_per_rank``: data=WORLD
  UltraQuery steps, the plan drawn on every rank (per rank: from
  ``default_rng(20 + rank)`` for its rows);
- ``train_queries``: ``train_queries`` with ``data_parallel``;
- ``evaluate_queries``: distributed evaluation of an odd number of queries;
- ``lp_zero_shot``, ``lp_trained``: ``scripts/torch_run.py`` (its ``main``,
  in this process) on the toy FB15k237 of DIR/lp, zero-shot and, at WORLD
  2, with one epoch of 2 steps: the metrics it prints.
"""

import ast
import contextlib
import io
import os
import pickle
import sys

import runpy

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ultra_tpu_torch import tasks  # noqa: E402
from ultra_tpu_torch.data.synthetic import synthetic_graph  # noqa: E402
from ultra_tpu_torch.models.nbfnet import NBFNetConfig, Ultra, UltraConfig  # noqa: E402
from ultra_tpu_torch.parallel import dp, multihost  # noqa: E402
from ultra_tpu_torch.parallel.mesh import make_mesh, shard_graph  # noqa: E402
from ultra_tpu_torch.query import executor as exe  # noqa: E402
from ultra_tpu_torch.query import trainer  # noqa: E402
from ultra_tpu_torch.train.distributed import evaluate_distributed, train_distributed  # noqa: E402,E501
from ultra_tpu_torch.train.loop import init_train_state  # noqa: E402

DIM = 32


def model_config(aggregate="sum"):
    def nb(**kw):
        return NBFNetConfig(input_dim=DIM, hidden_dims=(DIM, DIM), **kw)

    return UltraConfig(relation_model=nb(num_relation=4),
                       entity_model=nb(num_relation=1, project_relations=True,
                                       aggregate_func=aggregate))


def small_graph():
    """The 24-node graph of ``tests/test_parallel.py``, padded to 208 edges
    (a multiple of 2 and 4); with its host edge arrays."""
    return synthetic_graph(num_nodes=24, num_direct_rel=4, num_triples=100, seed=5,
                           device="cpu", pad_edges_to=208)


def step_record(loss, state):
    return {"loss": float(loss),
            "grads": {k: p.grad.detach().clone() for k, p in state.model.named_parameters()},
            "params": {k: v.detach().clone() for k, v in state.model.state_dict().items()}}


def run(rank, world, out):
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    weights = torch.load(os.path.join(out, "weights.pt"), weights_only=True)

    def fresh(aggregate="sum"):
        model = Ultra(model_config(aggregate))
        model.load_state_dict(weights[aggregate])
        return model

    graph, ei, et = small_graph()
    results = {}
    data_mesh = make_mesh(data=world)
    edge_mesh = make_mesh(data=1, edge=world)

    for mode, accum in (("dp", 1), ("dp_accum2", 2)):
        state = init_train_state(fresh(), lr=1e-3)
        step = dp.make_sharded_train_step(data_mesh, num_negative=4, grad_accum=accum)
        results[mode] = step_record(step(state, graph, inputs["batch"], inputs["ew"]), state)
    if world > 1:
        state = init_train_state(fresh(), lr=1e-3)
        step = dp.make_sharded_train_step(data_mesh, num_negative=4, per_rank_easy_edges=True)
        results["per_rank"] = step_record(step(state, graph, inputs["batch"], inputs["ew_rank"]),
                                          state)

    block = shard_graph(graph, edge_mesh)
    results["edge_block"] = {"live_edges": int(block.csr.col.numel()),
                             "padded_edges": block.num_edges_padded}
    for aggregate in ("sum", "pna"):
        model = fresh(aggregate)
        t_pred, h_pred = dp.make_sharded_score_step(edge_mesh)(model, block, inputs["score"])
        state = init_train_state(model, lr=1e-3)
        step = dp.make_sharded_train_step(edge_mesh, num_negative=4)
        record = step_record(step(state, block, inputs["batch"], inputs["ew"]), state)
        results[f"edge_{aggregate}"] = dict(record, t_pred=t_pred, h_pred=h_pred)
    if world > 1:
        from torch.distributed.nn import functional as dist_nn

        ops = {"sum": torch.distributed.ReduceOp.SUM, "max": torch.distributed.ReduceOp.MAX,
               "min": torch.distributed.ReduceOp.MIN}
        real = dp.combine_shards
        dp.combine_shards = lambda t, group, kind="sum": dist_nn.all_reduce(t, ops[kind], group)
        try:
            state = init_train_state(fresh(), lr=1e-3)
            step = dp.make_sharded_train_step(edge_mesh, num_negative=4)
            results["naive"] = step_record(step(state, block, inputs["batch"], inputs["ew"]),
                                           state)
        finally:
            dp.combine_shards = real

    n_direct = ei.shape[1] // 2
    triples = np.stack([ei[0, :n_direct], ei[1, :n_direct], et[:n_direct]], axis=1)
    index = tasks.GraphIndex.build(ei, et, graph.num_nodes, graph.num_relations)
    model = train_distributed({"batch_size": 4, "num_epoch": 2, "batch_per_epoch": 3},
                              {"num_negative": 4, "adversarial_temperature": 1.0}, fresh(),
                              graph, index, triples, seed=13, lr=1e-3)
    metrics = evaluate_distributed(model, graph, triples[:15], index, batch_size=4,
                                   metrics=("mr", "mrr", "hits@1", "hits@3"))
    results["trainer"] = {"params": {k: v.clone() for k, v in model.state_dict().items()},
                          "metrics": metrics}

    with open(os.path.join(out, "queries.pkl"), "rb") as f:
        ds = pickle.load(f)
    base = trainer.prepare_query_graph(ds.graphs[0], device="cpu")
    host = trainer.graph_host(ds.graphs[0], base)
    planner = trainer.dropout_planner(host, base)
    qcfg = exe.QueryConfig(dropout_ratio=0.5)
    kind, operand, target = inputs["kind"], inputs["operand"], inputs["target"]
    rows = data_mesh.rows(len(kind))
    sync = dp.grad_sync(data_mesh)
    for mode in ("query_per_slot", "query_grouped", "query_per_rank"):
        state = init_train_state(fresh(), lr=1e-3)
        if mode == "query_grouped":
            plan = exe.simulate_symbolic_grouped(kind, operand, *exe.projection_schedule(kind),
                                                 host, qcfg, np.random.default_rng(8), planner)
            step = trainer.make_grouped_query_train_step(qcfg, 1.0, sync_grads=sync)
        elif mode == "query_per_slot":
            plan = exe.simulate_symbolic(kind, operand, host, qcfg, np.random.default_rng(8),
                                         planner=planner)
            step = trainer.make_query_train_step(qcfg, 1.0, sync_grads=sync)
        else:
            plan = exe.simulate_symbolic(kind[rows], operand[rows], host, qcfg,
                                         np.random.default_rng(20 + data_mesh.data_index),
                                         planner=planner)
            step = trainer.make_query_train_step(qcfg, 1.0, sync_grads=sync)
        loss = step(state, exe.graphs_for_slots(base, plan), kind[rows], operand[rows],
                    target[rows])
        results[mode] = step_record(loss, state)

    cfg = {"train": {"batch_size": 8, "num_epoch": 1, "batch_per_epoch": 2,
                     "data_parallel": True},
           "task": {"adversarial_temperature": 0.2}, "optimizer": {"lr": 1e-3}}
    model = trainer.train_queries(cfg, fresh(), exe.QueryConfig(dropout_ratio=0.25), ds,
                                  os.path.join(out, f"train_queries{rank}_of{world}"), seed=0)
    results["train_queries"] = {"params": {k: v.clone() for k, v in model.state_dict().items()}}
    (_, _), (_, _), (lo, hi) = ds.split_ranges()
    idx = np.arange(lo, hi)[: inputs["num_eval_queries"]]
    results["evaluate_queries"] = trainer.evaluate_queries(
        fresh(), exe.QueryConfig(), trainer.prepare_query_graph(ds.graphs[2], device="cpu"), ds,
        idx, batch_size=2, metric_names=("mrr", "hits@1", "hits@3"))
    results["collectives"] = dict(dp.stats)
    torch.save(results, os.path.join(out, f"rank{rank}_of{world}.pt"))


def run_script(rank, world, port, out, epochs):
    """The metrics ``scripts/torch_run.py`` prints for the toy of DIR/lp
    (``--device cpu``; with ``epochs`` and 2 steps an epoch), run as its
    command line runs it: under ``ULTRA_DIST`` at ``world`` > 1."""
    lp = os.path.join(out, "lp")
    env = {"ULTRA_WORKDIR": os.path.join(lp, f"work{rank}_of{world}_e{epochs}"),
           "ULTRA_DIST": f"localhost:{port},{world},{rank}" if world > 1 else ""}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    argv = sys.argv
    sys.argv = ["torch_run.py", "-c", os.path.join(lp, "cfg.yaml"), "--epochs", str(epochs),
                "--bpe", "2", "--device", "cpu"]
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            runpy.run_path(os.path.join(REPO, "scripts", "torch_run.py"), run_name="__main__")
    finally:
        sys.argv = argv
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    lines = [line for line in printed.getvalue().splitlines() if line.startswith("{'valid'")]
    assert len(lines) == 1, printed.getvalue()
    return ast.literal_eval(lines[0])


def main():
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    if world > 1:
        multihost.initialize_from_env("cpu")
        assert multihost.process_count() == world and multihost.process_index() == rank
    run(rank, world, out)
    if world > 1:
        torch.distributed.destroy_process_group()
        results = {f"lp_{name}": run_script(rank, world, port, out, epochs)
                   for name, epochs in (("zero_shot", 0), ("trained", 1))}
        assert multihost.process_count() == world  # the script's group
        torch.distributed.destroy_process_group()
        torch.save(results, os.path.join(out, f"rank{rank}_of{world}_lp.pt"))


if __name__ == "__main__":
    main()
