"""The port's multi-process runs (``ultra_tpu_torch/parallel/``,
``train/distributed.py``, the data-parallel query steps) on the CPU: a real
gloo group of 2 worker processes (``tests/torch_parallel_worker.py``, torch
only) runs every mode once, the same code runs in this process as one rank,
and both are held to the JAX package on the same numpy inputs and weights:
its 8-device ``make_sharded_train_step`` / ``make_sharded_score_step`` at the
mesh of the mode, its 2-device query steps (per slot, grouped, per rank),
``train_distributed`` / ``evaluate_distributed``'s schedule, and
``train_queries`` with ``data_parallel`` on 2 devices (in a process of its
own, beside the workers). The graph and model are ``tests/test_parallel.py``'s:
24 nodes, 208 padded edges, 2 layers of width 32. The workers also run
``scripts/torch_run.py`` under ``ULTRA_DIST`` on a toy FB15k237 (20
entities, ``tests/test_torch_runner.py``'s), held to the 1-rank run and to
the JAX package's schedule.

Tolerances: losses and gradients within rtol 1e-4 / atol 1e-5 (f32 sums in
other orders: the halves of the batch or of the edges summed apart), the
weights after AdamW within the same bound; ranks and the integer parts of
the metrics equal, the metrics within 1e-6. A gradient off by the factor
``edge`` (an all-reduce whose backward sums again) fails the edge checks;
the worker's ``naive`` mode shows it does.
"""

import json
import logging
import os
import pickle
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_parallel_worker as worker
from tests.test_query_trainer import toy_query_dataset
from tests.test_torch_runner import METRICS, MODEL, write_transductive
from ultra_tpu import tasks as jtasks
from ultra_tpu.data import kg as jkg
from ultra_tpu.data.synthetic import synthetic_graph as jax_synthetic_graph
from ultra_tpu.models.nbfnet import NBFNetConfig as JNBFNetConfig
from ultra_tpu.models.nbfnet import UltraConfig as JUltraConfig
from ultra_tpu.parallel import multihost as jmultihost
from ultra_tpu.parallel.dp import make_sharded_score_step, make_sharded_train_step
from ultra_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ultra_tpu.query import executor as jexe
from ultra_tpu.query import ops as jops
from ultra_tpu.query import trainer as jtrainer
from ultra_tpu.train import distributed as jdistributed
from ultra_tpu.train import eval as jeval
from ultra_tpu.train import runner as jrunner
from ultra_tpu.train.loop import init_train_state as jax_init_train_state
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu.train.loop import make_optimizer as jax_make_optimizer
from ultra_tpu.utils.torch_ckpt import export_ultra_checkpoint
from ultra_tpu_torch.data import kg
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.parallel import multihost
from ultra_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_graph
from ultra_tpu_torch.query import datasets as qds
from ultra_tpu_torch.query import executor as exe
from ultra_tpu_torch.query import trainer
from ultra_tpu_torch.train import distributed
from ultra_tpu_torch.train.loop import init_train_state
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
NUM_EVAL_QUERIES = 3  # odd: the second rank's shard wraps around


def jax_config(aggregate="sum"):
    def nb(**kw):
        return JNBFNetConfig(input_dim=worker.DIM, hidden_dims=(worker.DIM,) * 2, **kw)

    return JUltraConfig(relation_model=nb(num_relation=4),
                        entity_model=nb(num_relation=1, project_relations=True,
                                        aggregate_func=aggregate))


def reveal_grads():
    """An optax transformation whose update turns the parameters into the
    gradients, so a JAX train step returns them."""
    return optax.GradientTransformation(
        lambda params: optax.EmptyState(),
        lambda grads, state, params: (jax.tree.map(lambda g, p: g - p, grads, params), state))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


LP_CFG = """output_dir: {lp}/output
dataset: {{class: FB15k237, root: {lp}/data}}
model: {model}
task:
  name: TransductiveInference
  num_negative: 4
  strict_negative: yes
  adversarial_temperature: 1
  metric: {metrics}
optimizer: {{lr: 1.0e-3}}
train:
  batch_size: 4
  num_epoch: {{{{ epochs }}}}
  batch_per_epoch: {{{{ bpe }}}}
checkpoint: {lp}/ultra.pth
"""

# train_queries with data_parallel on the JAX package's first 2 devices, as
# the workers run the port's (batch 8, 2 steps, dropout 0.25); its weights
# pickled to OUT/jax_train_queries.pkl
JAX_TRAIN_QUERIES = """import pickle, sys
sys.path.insert(0, {repo!r})
import tests.conftest
import jax
jax.config.update("jax_num_cpu_devices", 2)
from tests.test_query_trainer import toy_query_dataset
from tests.test_torch_parallel import jax_config
from ultra_tpu.query import executor as jexe, trainer as jtrainer
with open({out!r} + "/jax_params.pkl", "rb") as f:
    params = pickle.load(f)
cfg = {{"train": {{"batch_size": 8, "num_epoch": 1, "batch_per_epoch": 2,
                   "data_parallel": True}},
       "task": {{"adversarial_temperature": 0.2}}, "optimizer": {{"lr": 1e-3}}}}
assert jax.device_count() == 2
got = jtrainer.train_queries(cfg, jax_config(), jexe.QueryConfig(dropout_ratio=0.25), params,
                             toy_query_dataset(seed=1, n_queries=16), {out!r} + "/jax_tq",
                             seed=0)
with open({out!r} + "/jax_train_queries.pkl", "wb") as f:
    pickle.dump(jax.device_get(got), f)
"""


def write_link_prediction(lp):
    """The toy FB15k237 (both packages' caches built), its config for
    ``scripts/torch_run.py`` and the checkpoint the JAX package exports from
    seed-0 weights; returns (JAX params, JAX model config)."""
    os.makedirs(lp)
    write_transductive(os.path.join(lp, "data"))
    kg.build_dataset("FB15k237", os.path.join(lp, "data")).load()
    jkg.build_dataset("FB15k237", os.path.join(lp, "data")).load()
    with open(os.path.join(lp, "cfg.yaml"), "w") as f:
        f.write(LP_CFG.format(lp=lp, model=json.dumps(MODEL), metrics=json.dumps(METRICS)))
    jcfg = jrunner.model_config_from_dict(MODEL)
    params = jax.tree.map(np.asarray, jax_init_ultra_params(jcfg, jax.random.key(0)))
    export_ultra_checkpoint(params, os.path.join(lp, "ultra.pth"))
    return params, jcfg


class Run:
    """The inputs written for the workers, the 2-rank group started on them,
    and this process's 1-rank run of the same modes."""

    def __init__(self, out):
        self.out = str(out)
        self.jgraph, self.ei, self.et = jax_synthetic_graph(
            num_nodes=24, num_direct_rel=4, num_triples=100, seed=5, pad_edges_to=208)
        e_pad = self.jgraph.num_edges_padded
        self.index = jtasks.GraphIndex.build(self.ei, self.et, 24, 8)
        n_direct = self.ei.shape[1] // 2
        self.triples = np.stack([self.ei[0, :n_direct], self.ei[1, :n_direct],
                                 self.et[:n_direct]], axis=1)
        rng = np.random.default_rng(3)
        pos = self.triples[rng.choice(len(self.triples), size=8, replace=False)]
        batch = jtasks.negative_sampling(self.index, pos, num_negative=4, rng=rng)
        self.params = {agg: jax.device_get(jax_init_ultra_params(jax_config(agg),
                                                                 jax.random.key(key)))
                       for agg, key in (("sum", 1), ("pna", 2))}
        torch.save({agg: params_from_jax(p) for agg, p in self.params.items()},
                   os.path.join(self.out, "weights.pt"))

        self.queries = toy_query_dataset(seed=1, n_queries=16)
        port_ds = qds.QueryDataset(self.queries.name, tuple(
            qds.QueryGraph(*g) for g in self.queries.graphs), *self.queries[2:])
        with open(os.path.join(self.out, "queries.pkl"), "wb") as f:
            pickle.dump(port_ds, f)
        self.port_queries = port_ds
        self.query_graph = trainer.prepare_query_graph(port_ds.graphs[0], device="cpu")
        (tr_lo, tr_hi), _, _ = self.queries.split_ranges()
        take = np.arange(tr_lo, tr_hi)
        kind, operand = jops.decompose(self.queries.queries[take])
        target = jtrainer.answers_to_mask([self.queries.easy_answers[i] for i in take],
                                          self.queries.graphs[0].num_nodes).astype(np.float32)
        self.inputs = dict(
            batch=batch, ew=jtasks.easy_edge_weights(self.index, batch, e_pad),
            ew_rank=np.stack([jtasks.easy_edge_weights(self.index, rows, e_pad)
                              for rows in np.array_split(batch, 2)]),
            score=np.stack([rng.integers(0, 24, 8), rng.integers(0, 24, 8),
                            rng.integers(0, 4, 8)], axis=1),
            kind=kind, operand=operand, target=target,
            num_eval_queries=np.int64(NUM_EVAL_QUERIES))
        np.savez(os.path.join(self.out, "inputs.npz"), **self.inputs)
        self.lp_params, self.lp_jcfg = write_link_prediction(os.path.join(self.out, "lp"))
        with open(os.path.join(self.out, "jax_params.pkl"), "wb") as f:
            pickle.dump(self.params["sum"], f)

        group_port, script_port = str(_free_port()), str(_free_port())
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.logs = [open(os.path.join(self.out, f"worker{r}.log"), "w") for r in range(2)]
        # torchrun's environment, which the workers' first group is made from
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"), str(r),
             "2", script_port, self.out], stdout=self.logs[r], stderr=subprocess.STDOUT,
            env=dict(env, MASTER_ADDR="localhost", MASTER_PORT=group_port, WORLD_SIZE="2",
                     RANK=str(r), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2"))
            for r in range(2)]
        launcher = os.path.join(self.out, "jax_train_queries.py")
        with open(launcher, "w") as f:
            f.write(JAX_TRAIN_QUERIES.format(repo=REPO, out=self.out))
        self.logs.append(open(os.path.join(self.out, "jax_train_queries.log"), "w"))
        self.procs.append(subprocess.Popen([sys.executable, launcher], stdout=self.logs[2],
                                           stderr=subprocess.STDOUT, env=env))
        worker.run(0, 1, self.out)
        self.one = torch.load(os.path.join(self.out, "rank0_of1.pt"), weights_only=False)
        self.one["lp_zero_shot"] = worker.run_script(0, 1, None, self.out, 0)
        self._two = None

    def _wait(self, k):
        self.procs[k].wait(timeout=300)
        self.logs[k].close()
        assert self.procs[k].returncode == 0, open(self.logs[k].name).read()[-3000:]

    def two(self):
        """The two ranks' results, once both workers have exited."""
        if self._two is None:
            for r in range(2):
                self._wait(r)
            self._two = []
            for r in range(2):
                rec = torch.load(os.path.join(self.out, f"rank{r}_of2.pt"), weights_only=False)
                rec.update(torch.load(os.path.join(self.out, f"rank{r}_of2_lp.pt"),
                                      weights_only=False))
                self._two.append(rec)
        return self._two

    def jax_train_queries(self):
        """The weights of the JAX package's data-parallel ``train_queries``."""
        self._wait(2)
        with open(os.path.join(self.out, "jax_train_queries.pkl"), "rb") as f:
            return params_from_jax(pickle.load(f))

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    r = Run(tmp_path_factory.mktemp("parallel"))
    yield r
    r.close()


def jax_step(r, mesh_shape, aggregate="sum", **kw):
    """(loss, {name: gradient}) of the JAX package's sharded train step at
    ``mesh_shape`` on the run's batch and mask."""
    cfg, params = jax_config(aggregate), r.params[aggregate]
    opt = reveal_grads()
    step = make_sharded_train_step(jax_make_mesh(data=mesh_shape[0], edge=mesh_shape[1]), cfg,
                                   opt, r.jgraph, num_negative=4, **kw)
    ew = r.inputs["ew_rank"] if kw.get("per_rank_easy_edges") else r.inputs["ew"]
    state, loss = step(jax_init_train_state(params, opt), r.jgraph,
                       jnp.asarray(r.inputs["batch"]), jnp.asarray(ew))
    return float(loss), params_from_jax(jax.device_get(state.params))


def jax_replay(jcfg, params, jgraph, index, triples, seed, epochs, steps, world=2, bs=4):
    """The JAX params after ``train_distributed``'s schedule over ``world``
    ranks of ``bs`` rows (every rank's ``default_rng(seed + p)`` stream, the
    epoch's ``shard_indices`` with wrap-around, strict negatives, 4 a row),
    replayed through the JAX package's 8-device sharded step with AdamW at
    lr 1e-3."""
    opt = jax_make_optimizer(lr=1e-3)
    step = make_sharded_train_step(jax_make_mesh(edge=1), jcfg, opt, jgraph, num_negative=4)
    state = jax_init_train_state(params, opt)
    rank_rngs = [np.random.default_rng(seed + p) for p in range(world)]
    for epoch in range(epochs):
        shards = [jmultihost.shard_indices(len(triples), epoch=epoch, seed=seed,
                                           process_id=p, num_processes=world)
                  for p in range(world)]
        for s in range(steps):
            rows = []
            for p in range(world):
                take = shards[p][(s * bs) % len(shards[p]):][:bs]
                if len(take) < bs:
                    take = np.concatenate([take, shards[p][: bs - len(take)]])
                rows.append(jtasks.negative_sampling(index, triples[take], 4, strict=True,
                                                     rng=rank_rngs[p]))
            batch = np.concatenate(rows)
            ew = jtasks.easy_edge_weights(index, batch, jgraph.num_edges_padded)
            state, _ = step(state, jgraph, jnp.asarray(batch), jnp.asarray(ew))
    return state.params


def rank_order(n, world=2):
    """The order ``evaluate_distributed`` gathers ``n`` triples in: each
    rank's unshuffled shard, wrapped around, in rank order."""
    return np.concatenate([jmultihost.shard_indices(n, 0, shuffle=False, process_id=p,
                                                    num_processes=world)
                           for p in range(world)])


def assert_close(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=f"{what}: {k}", **TOL)


def assert_step(records, want_loss, want_grads, what):
    """Every rank's loss and gradients against the reference."""
    for i, rec in enumerate(records):
        np.testing.assert_allclose(rec["loss"], want_loss, err_msg=f"{what} rank {i}", **TOL)
        assert_close(rec["grads"], want_grads, f"{what} rank {i}")


# --- in process -------------------------------------------------------------

@pytest.mark.parametrize("n,world,epoch,seed", [(10, 2, 0, 0), (7, 4, 3, 1), (16, 4, 1, 5),
                                                (5, 8, 2, 2), (15, 2, 0, 13), (1, 3, 4, 9)])
def test_shard_indices_match_jax(n, world, epoch, seed):
    for shuffle in (True, False):
        for p in range(world):
            np.testing.assert_array_equal(
                multihost.shard_indices(n, epoch, seed, shuffle, p, world),
                jmultihost.shard_indices(n, epoch, seed, shuffle, p, world))


def test_world_of_one_gathers_and_meshes_without_a_group():
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    local = np.array([3, 1, 2])
    np.testing.assert_array_equal(multihost.gather_ranks(local), local)
    mesh = make_mesh()
    assert mesh == Mesh(1, 1)
    assert mesh.rows(8) == slice(0, 8) and mesh.edge_block(208) == slice(0, 208)
    with pytest.raises(ValueError, match="2x1"):
        make_mesh(data=2)
    graph, _, _ = worker.small_graph()
    assert shard_graph(graph, mesh) is graph
    with pytest.raises(ValueError, match="do not divide"):
        Mesh(1, 3, 0, 1).edge_block(208)
    with pytest.raises(ValueError, match="does not divide"):
        Mesh(3, 1).rows(8)


@pytest.mark.parametrize("cards,world,env,want", [
    (0, 1, {}, "gloo"),
    (8, 16, {}, "cpu:gloo,cuda:nccl"),  # ULTRA_DIST: 2 hosts x 8 cards, 16 ranks
    (8, 16, {"LOCAL_WORLD_SIZE": "8"}, "cpu:gloo,cuda:nccl"),  # torchrun, a host of 8
    (1, 2, {"LOCAL_WORLD_SIZE": "2"}, "gloo"),  # 2 ranks on one card
])
def test_backend_follows_the_ranks_of_a_host(monkeypatch, cards, world, env, want):
    """``initialize`` takes nccl when every rank of its host has its own card
    (the host's rank count is ``LOCAL_WORLD_SIZE``; without it, one rank a
    card, whatever the world size), gloo without a card or with more ranks
    than cards; a faked device count and a captured ``init_process_group``."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append(
        (backend, kw)))
    multihost.initialize("host0:29500", world, 1)
    assert calls == [(want, {"init_method": "tcp://host0:29500", "world_size": world,
                             "rank": 1})]


def test_shard_graph_blocks_keep_every_node_and_the_relation_graph():
    """Each block of a 2-way cut: the slice of the padded arrays, every node,
    the relation graph itself; the two blocks' live edges are the graph's."""
    graph, _, _ = worker.small_graph()
    live = []
    for e in range(2):
        block = shard_graph(graph, Mesh(1, 2, 0, e, edge_group="group"))
        assert block.num_nodes == graph.num_nodes
        assert block.num_relations == graph.num_relations
        assert block.relation_graph is graph.relation_graph and block.edge_group == "group"
        sl = slice(104 * e, 104 * (e + 1))
        assert torch.equal(block.edge_index, graph.edge_index[:, sl])
        assert torch.equal(block.edge_weight, graph.edge_weight[sl])
        assert int(block.csr.rowptr[-1]) == int((block.edge_weight != 0).sum())
        live.append(block.csr.col.numel())
    assert sum(live) == graph.csr.col.numel()


def test_train_distributed_one_rank_matches_jax(run, caplog):
    """``train_distributed`` at one rank, with a validation after each of its
    2 epochs, against the JAX package's on its 8 devices: the validation MRR
    of each epoch and the best epoch's weights it returns."""
    r = run
    cfg = ({"batch_size": 8, "num_epoch": 2, "batch_per_epoch": 2},
           {"num_negative": 4, "adversarial_temperature": 1.0})
    model = Ultra(worker.model_config())
    model.load_state_dict(params_from_jax(r.params["sum"]))
    graph, _, _ = worker.small_graph()
    with caplog.at_level(logging.WARNING):
        out = distributed.train_distributed(*cfg, model, graph, r.index, r.triples,
                                            valid_triples=r.triples[:9], seed=3, lr=1e-3)
        port_log = caplog.text
        caplog.clear()
        jout = jdistributed.train_distributed(*cfg, jax_config(), r.params["sum"], r.jgraph,
                                              r.index, r.triples, valid_triples=r.triples[:9],
                                              seed=3, lr=1e-3)
        jax_log = caplog.text
    pattern = r"valid after epoch \d: \{'mrr': ([0-9.e-]+)"
    got, want = re.findall(pattern, port_log), re.findall(pattern, jax_log)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(np.array(got, float), np.array(want, float), rtol=0, atol=1e-6)
    assert_close(out.state_dict(), params_from_jax(jax.device_get(jout)), "best weights")


# --- the 2-rank group, the 1-rank port and the JAX package -------------------

@pytest.mark.parametrize("mode,mesh,kw", [
    ("dp", (8, 1), {}),
    ("dp_accum2", (2, 4), {"grad_accum": 2}),
    ("per_rank", (2, 4), {"per_rank_easy_edges": True}),
])
def test_data_parallel_steps_match_jax_and_one_rank(run, mode, mesh, kw):
    """data=2 steps (grad_accum 1 and 2; per-rank easy edges, whose oracle
    is JAX's with 2 data shards): both ranks' loss and averaged gradients
    against the JAX sharded step, and the weights after AdamW against the
    1-rank port's (per-rank: against each other)."""
    loss, grads = jax_step(run, mesh, **kw)
    two = run.two()  # the JAX side ran while the workers did
    assert_step([t[mode] for t in two], loss, grads, mode)
    if mode == "per_rank":
        assert_close(two[1][mode]["params"], two[0][mode]["params"], mode)
        return
    assert_step([run.one[mode]], loss, grads, mode + " one rank")
    for t in two:
        assert_close(t[mode]["params"], run.one[mode]["params"], mode)


@pytest.mark.parametrize("aggregate", ["sum", "pna"])
def test_edge_sharded_score_and_train_match_jax_and_one_rank(run, aggregate):
    """edge=2 (each rank a 104-edge block): all-node scores against JAX's
    sharded score step at mesh (4, 2); the train step's loss and gradients
    against JAX's at (4, 2) and the 1-rank port's (a gradient counted twice
    fails); the weights after AdamW against the 1-rank port's."""
    mode = f"edge_{aggregate}"
    cfg, params = jax_config(aggregate), run.params[aggregate]
    score = make_sharded_score_step(jax_make_mesh(data=4, edge=2), cfg, run.jgraph)
    t_pred, h_pred = (np.asarray(a) for a in score(params, run.jgraph,
                                                   jnp.asarray(run.inputs["score"])))
    loss, grads = jax_step(run, (4, 2), aggregate)
    two = run.two()  # the JAX side ran while the workers did
    assert sum(t["edge_block"]["live_edges"] for t in two) == run.one["edge_block"]["live_edges"]
    assert {t["edge_block"]["padded_edges"] for t in two} == {104}
    for rec in [t[mode] for t in two] + [run.one[mode]]:
        np.testing.assert_allclose(rec["t_pred"].numpy(), t_pred, **TOL)
        np.testing.assert_allclose(rec["h_pred"].numpy(), h_pred, **TOL)
    assert_step([t[mode] for t in two] + [run.one[mode]], loss, grads, mode)
    for t in two:
        assert_close(t[mode]["params"], run.one[mode]["params"], mode)


def test_edge_gradient_check_catches_a_doubled_gradient(run):
    """The control of the edge checks: with ``torch.distributed.nn``'s
    autograd all-reduce as the combine (its backward sums the whole gradient
    again), the gradients of the last entity layer's relation projection,
    which reach the loss through that layer's combine alone, come out twice
    the 1-rank port's, and the check above fails on the step."""
    two = run.two()
    want = run.one["edge_sum"]["grads"]
    projections = [k for k in want if k.startswith("entity_model.layers.1.relation_projection.")]
    assert len(projections) == 4
    for t in two:
        got = t["naive"]["grads"]
        for k in projections:
            np.testing.assert_allclose(got[k].numpy(), 2 * want[k].numpy(), err_msg=k, **TOL)
        with pytest.raises(AssertionError):
            assert_close(got, want, "naive")


def test_two_ranks_train_distributed_and_evaluate_match_jax_schedule(run):
    """``train_distributed`` over 2 ranks (batch 4 each, 2 epochs of 3
    steps, seed 13) against the same schedule replayed through JAX's
    8-device sharded step; ``evaluate_distributed`` of 15 triples (the
    second shard wraps around to the first) against JAX's rankings of the
    shards' triples, duplicate and all."""
    jcfg = jax_config()
    params = jax_replay(jcfg, run.params["sum"], run.jgraph, run.index, run.triples, seed=13,
                        epochs=2, steps=3)
    want = params_from_jax(jax.device_get(params))
    two = run.two()  # the JAX side ran while the workers did
    for t in two:
        assert_close(t["trainer"]["params"], want, "trainer")
    order = rank_order(15)
    assert len(order) == 16 and order[-1] == order[0]
    metrics = jeval.compute_metrics(("mr", "mrr", "hits@1", "hits@3"), *jeval.collect_rankings(
        params, jcfg, run.jgraph, run.triples[:15][order], run.index, batch_size=4))
    for t in two:
        assert list(t["trainer"]["metrics"]) == list(metrics)
        np.testing.assert_allclose(list(t["trainer"]["metrics"].values()),
                                   list(metrics.values()), rtol=0, atol=1e-6)


def test_run_link_prediction_across_two_ranks_matches_one_rank_and_jax(run):
    """``scripts/torch_run.py`` in each worker under ``ULTRA_DIST`` (its
    group made from it) on the toy FB15k237: zero-shot, both ranks print the
    metrics of the 1-rank run (the single-process branch, which
    ``test_torch_runner.py`` holds to the JAX package); after one epoch of 2
    steps of 4 rows a rank, the metrics of the JAX package's sharded step
    replaying ``train_distributed``'s schedule from the same checkpoint
    (seed 1024), then ranking the valid and test triples."""
    dataset = jkg.build_dataset("FB15k237", os.path.join(run.out, "lp", "data")).load()
    train = dataset.train
    index = jtasks.GraphIndex.build(train.edge_index, train.edge_type, train.num_nodes,
                                    train.num_relations)
    params = jax_replay(run.lp_jcfg, run.lp_params,
                        jrunner.prepare_graph(train, with_plans=False), index,
                        jrunner.triples_of(train), seed=1024, epochs=1, steps=2)
    filtered = jrunner.build_filtered_index(dataset, "FB15k237", "TransductiveInference")
    trained = {}
    for split in ("valid", "test"):
        trips = jrunner.triples_of(getattr(dataset, split))
        trained[split] = jeval.compute_metrics(METRICS, *jeval.collect_rankings(
            params, run.lp_jcfg, jrunner.prepare_graph(getattr(dataset, split),
                                                      with_plans=False),
            trips[rank_order(len(trips))], filtered[split], batch_size=4))
    two = run.two()  # the JAX side ran while the workers did
    for t in two:
        for name, want_run in (("lp_zero_shot", run.one["lp_zero_shot"]),
                               ("lp_trained", trained)):
            assert t[name].keys() == {"valid", "test"}, name
            for split in ("valid", "test"):
                got, want = t[name][split], want_run[split]
                assert list(got) == list(want) == METRICS, name
                np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=0,
                                           atol=1e-6, err_msg=f"{name} {split}")


def _port_query_step(run, plan, rows, grouped=False):
    """(loss, {name: gradient}) of the port's single-process query step on
    the batch's ``rows`` and ``plan`` (the steps ``test_torch_query_train.py``
    holds to the JAX package)."""
    qcfg = exe.QueryConfig(dropout_ratio=0.5)
    model = Ultra(worker.model_config())
    model.load_state_dict(params_from_jax(run.params["sum"]))
    state = init_train_state(model, lr=1e-3)
    step = (trainer.make_grouped_query_train_step(qcfg, 1.0) if grouped
            else trainer.make_query_train_step(qcfg, 1.0))
    kind, operand, target = (run.inputs[k][rows] for k in ("kind", "operand", "target"))
    loss = step(state, exe.graphs_for_slots(run.query_graph, plan), kind, operand, target)
    return float(loss), {k: p.grad for k, p in model.named_parameters()}


def _port_plan(run, rng, rows=slice(None), grouped=False):
    qcfg = exe.QueryConfig(dropout_ratio=0.5)
    kind, operand = run.inputs["kind"][rows], run.inputs["operand"][rows]
    host = trainer.graph_host(run.queries.graphs[0], run.query_graph)
    planner = trainer.dropout_planner(host, run.query_graph)
    if grouped:
        return exe.simulate_symbolic_grouped(kind, operand, *exe.projection_schedule(kind), host,
                                             qcfg, rng, planner)
    return exe.simulate_symbolic(kind, operand, host, qcfg, rng, planner=planner)


@pytest.mark.parametrize("mode", ["query_per_slot", "query_grouped", "query_per_rank"])
def test_data_parallel_query_steps_match_one_rank(run, mode):
    """data=2 UltraQuery steps on the 8 training queries, each rank on 4:
    per slot and grouped on the batch's one plan (every rank draws it),
    against the port's step on the whole batch and the 1-rank run; per
    rank, each rank's own plan of its rows, against the mean of the port's
    steps on each half with that half's plan (the reference's DDP)."""
    two = run.two()
    if mode == "query_per_rank":
        halves = np.array_split(np.arange(8), 2)
        steps = [_port_query_step(run, _port_plan(run, np.random.default_rng(20 + s), rows),
                                  rows) for s, rows in enumerate(halves)]
        loss = np.mean([l for l, _ in steps])
        grads = {k: (steps[0][1][k] + steps[1][1][k]) / 2 for k in steps[0][1]}
        assert_step([t[mode] for t in two], loss, grads, mode)
        assert_close(two[1][mode]["params"], two[0][mode]["params"], mode)
        return
    grouped = mode == "query_grouped"
    plan = _port_plan(run, np.random.default_rng(8), grouped=grouped)
    loss, grads = _port_query_step(run, plan, slice(None), grouped)
    assert_step([t[mode] for t in two] + [run.one[mode]], loss, grads, mode)
    for t in two:
        assert_close(t[mode]["params"], run.one[mode]["params"], mode)


def jax_query_graph(run):
    """The JAX package's training query graph and its host dict."""
    qg = run.queries.graphs[0]
    jgraph = jtrainer.prepare_query_graph(qg, with_plans=False)
    jhost = {"edge_index": qg.edge_index, "edge_type": qg.edge_type,
             "num_nodes": qg.num_nodes, "num_relations": qg.num_relations,
             "e_pad": jgraph.num_edges_padded, "inverse_rel_plus_one": qg.inverse_rel_plus_one}
    return jgraph, jhost


def test_data_parallel_query_step_matches_jax_sharded_step(run):
    """The per-slot data=2 step against the JAX package's
    ``make_sharded_query_train_step`` on a mesh of 2 devices, the plan drawn
    from the same seed in both packages: the loss and the gradients."""
    qcfg = jexe.QueryConfig(dropout_ratio=0.5)
    jgraph, jhost = jax_query_graph(run)
    kind, operand, target = (run.inputs[k] for k in ("kind", "operand", "target"))
    plan = jexe.simulate_symbolic(kind, operand, jhost, qcfg, np.random.default_rng(8),
                                  planner=jexe.DropoutPlanner(jhost))
    graphs = jexe.graphs_for_slots(jgraph, plan)
    opt = reveal_grads()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("data",))
    step = jtrainer.make_sharded_query_train_step(jax_config(), qcfg, opt, mesh, 1.0)(graphs)
    state, loss = step(jax_init_train_state(run.params["sum"], opt), tuple(graphs),
                       jnp.asarray(kind), jnp.asarray(operand), jnp.asarray(target))
    two = run.two()  # the JAX side ran while the workers did
    assert_step([t["query_per_slot"] for t in two], float(loss),
                params_from_jax(jax.device_get(state.params)), "query_per_slot")


@pytest.mark.parametrize("mode", ["query_grouped", "query_per_rank"])
def test_grouped_and_per_rank_query_steps_match_jax_sharded_steps(run, mode):
    """The grouped data=2 step against ``make_sharded_grouped_query_train_step``
    (the batch's one grouped plan, from seed 8 in both packages), and the
    per-rank one against ``make_per_rank_query_train_step`` with
    ``per_rank_slot_weights`` of each half's own plan (from seed 20 + s), on
    a mesh of 2 devices: both ranks' loss and gradients."""
    qcfg = jexe.QueryConfig(dropout_ratio=0.5)
    jgraph, jhost = jax_query_graph(run)
    planner = jexe.DropoutPlanner(jhost)
    kind, operand, target = (run.inputs[k] for k in ("kind", "operand", "target"))
    opt = reveal_grads()
    state = jax_init_train_state(run.params["sum"], opt)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("data",))
    if mode == "query_grouped":
        plan = jexe.simulate_symbolic_grouped(kind, operand, *jexe.projection_schedule(kind),
                                              jhost, qcfg, np.random.default_rng(8), planner)
        step = jtrainer.make_sharded_grouped_query_train_step(jax_config(), qcfg, opt, mesh, 1.0)
        state, loss = step(state, jexe.graphs_for_slots(jgraph, plan), kind, operand, target)
    else:
        rel_pad = jgraph.relation_graph.num_edges_padded
        plans = [jexe.simulate_symbolic(kind[rows], operand[rows], jhost, qcfg,
                                        np.random.default_rng(20 + s), rel_pad_to=rel_pad,
                                        training=True, planner=planner)
                 for s, rows in enumerate(np.array_split(np.arange(len(kind)), 2))]
        slot_ew, slot_rel = jtrainer.per_rank_slot_weights(jgraph, plans)
        step = jtrainer.make_per_rank_query_train_step(jax_config(), qcfg, opt, mesh,
                                                       1.0)(jgraph)
        state, loss = step(state, jgraph, jnp.asarray(slot_ew), jnp.asarray(slot_rel),
                           jnp.asarray(kind), jnp.asarray(operand), jnp.asarray(target))
    two = run.two()  # the JAX side ran while the workers did
    assert_step([t[mode] for t in two], float(loss),
                params_from_jax(jax.device_get(state.params)), mode)


def test_train_queries_data_parallel_matches_jax(run):
    """``train_queries`` with ``data_parallel`` (batch 8, 2 steps, dropout
    0.25) over 2 ranks against the JAX package's ``train_queries`` with
    ``data_parallel`` on 2 devices from the same weights and seed: the
    weights it returns."""
    want = run.jax_train_queries()
    for rec in run.two():
        assert_close(rec["train_queries"]["params"], want, "train_queries")


def test_train_queries_data_parallel_matches_one_process(run, tmp_path):
    """``train_queries`` with ``data_parallel`` (batch 8, 2 steps, dropout
    0.25, the validation's evaluation distributed) over 2 ranks and over 1
    returns the weights of the single-process ``train_queries``, which
    ``test_torch_query_train.py`` holds to the JAX package's (whose own
    data-parallel loop keeps its single-device numbers)."""
    two = run.two()
    cfg = {"train": {"batch_size": 8, "num_epoch": 1, "batch_per_epoch": 2},
           "task": {"adversarial_temperature": 0.2}, "optimizer": {"lr": 1e-3}}
    model = Ultra(worker.model_config())
    model.load_state_dict(params_from_jax(run.params["sum"]))
    want = trainer.train_queries(cfg, model, exe.QueryConfig(dropout_ratio=0.25),
                                 run.port_queries, str(tmp_path), seed=0).state_dict()
    for rec in two + [run.one]:
        assert_close(rec["train_queries"]["params"], want, "train_queries")


def test_distributed_evaluate_queries_matches_one_process(run):
    """``evaluate_queries`` of 3 test queries over 2 ranks (the second shard
    wraps around to the first query) equals the single-process evaluation
    of the shards' queries, duplicate and all (``test_torch_query.py``
    holds it to the JAX package's); over 1 rank, of all 3."""
    two = run.two()
    (_, _), (_, _), (lo, hi) = run.queries.split_ranges()
    idx = np.arange(lo, hi)[:NUM_EVAL_QUERIES]
    order = rank_order(len(idx))
    assert len(order) == 4 and order[-1] == order[0]
    model = Ultra(worker.model_config())
    model.load_state_dict(params_from_jax(run.params["sum"]))
    graph = trainer.prepare_query_graph(run.queries.graphs[2], device="cpu")
    for ranks, indices in ((two, idx[order]), ([run.one], idx)):
        want = trainer.evaluate_queries(model, exe.QueryConfig(), graph, run.port_queries,
                                        indices, batch_size=2,
                                        metric_names=("mrr", "hits@1", "hits@3"))
        for rec in ranks:
            got = rec["evaluate_queries"]
            assert list(got) == list(want)
            np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=0,
                                       atol=1e-6)


def test_ranks_agree_and_count_their_collectives(run):
    """Both ranks hold the same weights after every mode and made the same
    all-reduces; the 1-rank port made none."""
    two = run.two()
    for mode in ("dp", "dp_accum2", "edge_sum", "edge_pna", "trainer", "train_queries"):
        for k, v in two[0][mode]["params"].items():
            assert torch.equal(v, two[1][mode]["params"][k]), (mode, k)
    assert two[0]["collectives"] == two[1]["collectives"]
    assert two[0]["collectives"]["calls"] > 0 and run.one["collectives"]["calls"] == 0
