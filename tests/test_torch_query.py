"""UltraQuery's answering path in the port (``ultra_tpu_torch/query``,
``models/nbfnet.py::query_nbfnet_apply``) against the JAX package on the
CPU, at a small size (2 layers of width 16), from the same weights
(``utils/torch_ckpt.py::params_from_jax``) and the same numpy inputs.

Tolerances: programs, datasets, schedules and metrics exactly (numpy on
both sides, or integer arithmetic); probabilities of one projection within
1e-5 absolute; the executors' probabilities within 2e-5 absolute (a few
projections chained, each 2 conv layers of f32 summed in other orders);
``execute_grouped`` against ``execute`` within rtol 1e-5 and atol 1e-6 on
logits, as the JAX package's own test holds its two executors; the
evaluation's metrics within 1e-6.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_query_datasets import write_transductive_fixture
from tests.test_query_trainer import toy_query_dataset
from ultra_tpu.models.nbfnet import NBFNetConfig as JNBFNetConfig
from ultra_tpu.models.nbfnet import UltraConfig as JUltraConfig
from ultra_tpu.models.nbfnet import query_nbfnet_apply as jax_query_nbfnet_apply
from ultra_tpu.query import datasets as jds
from ultra_tpu.query import executor as jexe
from ultra_tpu.query import metrics as jmetrics
from ultra_tpu.query import ops as jops
from ultra_tpu.query import trainer as jtrainer
from ultra_tpu.train.eval import precompute_relation_representations as jax_precompute
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu_torch.models.nbfnet import NBFNetConfig, Ultra, UltraConfig, query_nbfnet_apply
from ultra_tpu_torch.query import datasets as qds
from ultra_tpu_torch.query import executor as exe
from ultra_tpu_torch.query import metrics as qmetrics
from ultra_tpu_torch.query import ops
from ultra_tpu_torch.query import trainer
from ultra_tpu_torch.train.eval import precompute_relation_representations
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

D = 16
LOGICS = ("product", "godel", "lukasiewicz")
PROB_ATOL_ONE_HOP, PROB_ATOL = 1e-5, 2e-5

# BetaE's 14 query types (one union form, DNF) as nested structures:
# "e" an entity, "r" a relation, "n" a negation, "u" a union
TYPES = {t: s for s, t in jds.STRUCT2TYPE.items() if not t.endswith("-DM")}


def instantiate(struct, rng, num_nodes, num_relations):
    """A BetaE nested query of ``struct`` with random ids."""
    if struct == "e":
        return int(rng.integers(num_nodes))
    if struct == "r":
        return int(rng.integers(num_relations))
    if struct == "n":
        return -2
    if struct == "u":
        return -1
    return tuple(instantiate(s, rng, num_nodes, num_relations) for s in struct)


def configs(dim=D, layers=2):
    def nb(mod, **kw):
        return mod(input_dim=dim, hidden_dims=(dim,) * layers, **kw)

    return (
        JUltraConfig(relation_model=nb(JNBFNetConfig, num_relation=4),
                     entity_model=nb(JNBFNetConfig, num_relation=1, project_relations=True)),
        UltraConfig(relation_model=nb(NBFNetConfig, num_relation=4),
                    entity_model=nb(NBFNetConfig, num_relation=1, project_relations=True)),
    )


def query_graph(one_way=False, v=25, r_direct=4, triples=120, seed=11):
    """A QueryGraph with BetaE's inverse convention (direct 2r, inverse
    2r+1); ``one_way`` keeps the direct edges alone, so a graph read with
    its rows swapped would give other answers."""
    rng = np.random.default_rng(seed)
    h, t = rng.integers(0, v, triples), rng.integers(0, v, triples)
    r = rng.integers(0, r_direct, triples)
    if one_way:
        ei, et = np.stack([h, t]), 2 * r
    else:
        ei = np.concatenate([np.stack([h, t]), np.stack([t, h])], axis=1)
        et = np.concatenate([2 * r, 2 * r + 1])
    return jds.QueryGraph(ei.astype(np.int64), et.astype(np.int64), v, 2 * r_direct, True)


class Setup:
    """One QueryGraph on both packages, and one set of weights."""

    def __init__(self, one_way=False, seed=3):
        self.qg = query_graph(one_way)
        self.jcfg, pcfg = configs()
        self.params = jax.device_get(jax_init_ultra_params(self.jcfg, jax.random.key(seed)))
        self.model = Ultra(pcfg)
        self.model.load_state_dict(params_from_jax(self.params))
        self.model.eval()
        self.jgraph = jtrainer.prepare_query_graph(self.qg, with_plans=False)
        self.graph = trainer.prepare_query_graph(self.qg, device="cpu")


SETUPS = {}


def get_setup(one_way):
    if one_way not in SETUPS:
        SETUPS[one_way] = Setup(one_way)
    return SETUPS[one_way]


@pytest.fixture(params=[False, True], ids=["both-ways", "one-way"])
def setup(request):
    return get_setup(request.param)


def betae_batch(rng, num_nodes, num_relations):
    """One query of each of the 14 types, padded to one length, and the
    nested queries."""
    nested = [instantiate(s, rng, num_nodes, num_relations) for s in TYPES.values()]
    progs = [jops.from_nested(q) for q in nested]
    return jops.pad_queries(progs, max(len(p) for p in progs)), nested


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


# -- ops ---------------------------------------------------------------------


def test_ops_match_jax_on_every_betae_structure():
    rng = np.random.default_rng(0)
    progs = []
    for struct in jds.STRUCT2TYPE:  # the 16 structures, DM forms included
        nested = instantiate(struct, rng, 4000, 240)
        got, want = ops.from_nested(nested), jops.from_nested(nested)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        assert ops.to_readable(got) == jops.to_readable(want)
        for a, b in zip(ops.computation_graph(got), jops.computation_graph(want)):
            np.testing.assert_array_equal(a, b)
        assert ops.num_projections(got) == jops.num_projections(want)
        progs.append(got)
    padded = ops.pad_queries(progs, 12)
    np.testing.assert_array_equal(padded, jops.pad_queries(progs, 12))
    for a, b in zip(ops.decompose(padded), jops.decompose(padded)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="does not fit"):
        ops.pad_queries(progs, 2)
    with pytest.raises(ValueError, match="n-ary"):
        ops.from_nested((1, (2,)), binary_op=False)


def test_decompose_keeps_ids_up_to_the_opcode_bits():
    """Operands up to 2**31 - 1 survive the int64 program; an id in the
    opcode bits aliases an operation in both packages."""
    big = 2**31 - 1
    prog = ops.from_nested(((big, (big,)), (5, (7,))))
    kind, operand = ops.decompose(prog[None])
    assert operand[0, 0] == big and operand[0, 1] == big
    assert kind[0, 1] == ops.K_PROJECTION
    alias = ops.from_nested((0, (2**58 + 1,)))
    np.testing.assert_array_equal(ops.decompose(alias[None])[0],
                                  jops.decompose(alias[None])[0])


# -- datasets ----------------------------------------------------------------


def assert_same_query_dataset(got, want):
    assert got.name == want.name and got.id2type == want.id2type
    assert got.num_samples == want.num_samples
    for a, b in ((got.queries, want.queries), (got.types, want.types),
                 (got.num_entity_for_sample, want.num_entity_for_sample)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a_list, b_list in ((got.easy_answers, want.easy_answers),
                           (got.hard_answers, want.hard_answers)):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(got.graphs, want.graphs):
        assert (g.num_nodes, g.num_relations, g.inverse_rel_plus_one) == \
            (w.num_nodes, w.num_relations, w.inverse_rel_plus_one)
        np.testing.assert_array_equal(g.edge_index, w.edge_index)
        np.testing.assert_array_equal(g.edge_type, w.edge_type)
        if w.restrict_nodes is None:
            assert g.restrict_nodes is None
        else:
            np.testing.assert_array_equal(g.restrict_nodes, w.restrict_nodes)
    assert got.split_ranges() == want.split_ranges()


def _write_triples(path, fname, triples):
    with open(os.path.join(path, fname), "w") as f:
        for h, r, t in triples:
            f.write(f"{h} {r} {t}\n")


def write_inductive_fixture(root, extended=False):
    """A node-range-partitioned query dataset (version 9999), with the
    extended evaluation's answer files when ``extended``."""
    path = os.path.join(root, "9999")
    os.makedirs(path, exist_ok=True)
    _write_triples(path, "train_graph.txt", [(0, 0, 1), (1, 1, 2), (2, 0, 3), (3, 1, 4)])
    _write_triples(path, "val_inference.txt", [(4, 0, 5), (5, 1, 6)])
    _write_triples(path, "test_inference.txt", [(4, 1, 7), (7, 0, 8)])
    s1p, s2u = ("e", ("r",)), (("e", ("r",)), ("e", ("r",)), ("u",))
    q1, q2u = (0, (0,)), ((0, (0,)), (1, (1,)), (-1,))
    for split in ("train", "valid", "test"):
        with open(os.path.join(path, f"{split}_queries.pkl"), "wb") as f:
            pickle.dump({s1p: {q1}, s2u: {q2u}}, f)
        with open(os.path.join(path, f"{split}_answers_hard.pkl"), "wb") as f:
            pickle.dump({s1p: {q1: {1}}, s2u: {q2u: {1, 2}}}, f)
        if split != "train":
            with open(os.path.join(path, f"{split}_answers_easy.pkl"), "wb") as f:
                pickle.dump({s1p: {q1: set()}, s2u: {q2u: {3}}}, f)
    if extended:
        for split, extra in (("valid", 5), ("test", 7)):
            with open(os.path.join(path, f"train_answers_{split}.pkl"), "wb") as f:
                pickle.dump({s1p: {0: {1, extra}}, s2u: {0: {2}}}, f)


def write_wikitopics_fixture(root):
    path = os.path.join(root, "WikiTopics_QE", "art")
    os.makedirs(path)
    _write_triples(path, "train_graph.txt", [(0, 0, 1), (1, 1, 2), (2, 0, 3), (3, 1, 4)])
    _write_triples(path, "test_inference.txt", [(0, 0, 2), (2, 1, 3), (3, 0, 1)])
    s1p, q1 = ("e", ("r",)), (0, (0,))
    with open(os.path.join(path, "train_queries.pkl"), "wb") as f:
        pickle.dump({s1p: {q1}}, f)
    with open(os.path.join(path, "train_answers_hard.pkl"), "wb") as f:
        pickle.dump({s1p: {q1: {1}}}, f)
    for split in ("valid", "test"):
        with open(os.path.join(path, f"{split}_queries.pkl"), "wb") as f:
            pickle.dump({s1p: {q1}}, f)
        with open(os.path.join(path, f"{split}_answers_easy.pkl"), "wb") as f:
            pickle.dump({s1p: {q1: set()}}, f)
        with open(os.path.join(path, f"{split}_answers_hard.pkl"), "wb") as f:
            pickle.dump({s1p: {q1: {2}}}, f)


@pytest.mark.parametrize("family", ["transductive", "transductive-DM", "inductive",
                                    "extended", "wikitopics"])
def test_query_datasets_match_jax(tmp_path, family):
    root = str(tmp_path)
    if family.startswith("transductive"):
        write_transductive_fixture(root)
        kw = {"union_type": "DM"} if family.endswith("DM") else {}

        class Port(qds.LogicalQueryDataset):
            name = "toy-betae"

        class Jax(jds.LogicalQueryDataset):
            name = "toy-betae"

        got, want = Port(root, **kw).load(), Jax(root, **kw).load()
    elif family == "wikitopics":
        write_wikitopics_fixture(root)
        got = qds.build_query_dataset("WikiTopicsQuery", root, version="art").load()
        want = jds.build_query_dataset("WikiTopicsQuery", root, version="art").load()
    else:
        write_inductive_fixture(root, extended=family == "extended")
        name = ("InductiveFB15k237QueryExtendedEval" if family == "extended"
                else "InductiveFB15k237Query")
        got = qds.build_query_dataset(name, root, version=9999).load()
        want = jds.build_query_dataset(name, root, version=9999).load()
    assert_same_query_dataset(got, want)


def test_joint_query_dataset_is_refused():
    with pytest.raises(NotImplementedError, match="A10"):
        qds.build_query_dataset("JointQueryDataset", "/nonexistent", graphs=["FB15k237"])
    assert set(qds.QUERY_DATASETS) | set(qds.UNPORTED) == set(jds.QUERY_DATASETS)


# -- metrics -----------------------------------------------------------------


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    b, v = 12, 40
    pred = rng.integers(0, 6, (b, v)).astype(np.float32)  # many ties
    easy = rng.random((b, v)) < 0.1
    hard = (rng.random((b, v)) < 0.1) & ~easy
    hard[0] = False  # a query with no hard answer
    restrict = rng.permutation(v)[:30]
    for r in (None, restrict):
        got, want = qmetrics.batch_evaluate(pred, easy, hard, r), \
            jmetrics.batch_evaluate(pred, easy, hard, r)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)
    rank, answer_rank, n_easy, n_hard = jmetrics.batch_evaluate(pred, easy, hard)
    types = rng.integers(0, 3, b)
    num_pred = rng.random(b) * 5
    names = ("mrr", "hits@1", "hits@3", "hits@10", "mape", "spearmanr", "auroc")
    id2type = ["1p", "2in", "up-DNF"]
    got = qmetrics.evaluate(rank, answer_rank, n_easy, n_hard, types, num_pred, names, id2type)
    want = jmetrics.evaluate(rank, answer_rank, n_easy, n_hard, types, num_pred, names,
                             id2type)
    assert list(got) == list(want)
    np.testing.assert_array_equal(np.array(list(got.values())), np.array(list(want.values())))
    with pytest.raises(ValueError, match="unknown metric"):
        qmetrics.evaluate(rank, answer_rank, n_easy, n_hard, types, num_pred, ["mr"], id2type)


# -- the model and one projection -------------------------------------------


def test_query_nbfnet_apply_matches_jax(setup):
    rng = np.random.default_rng(2)
    b, v, r = 3, setup.qg.num_nodes, setup.qg.num_relations
    boundary = rng.random((v, b, D)).astype(np.float32)
    rel_reprs = rng.normal(size=(b, r, D)).astype(np.float32)
    query = rng.normal(size=(b, D)).astype(np.float32)
    want = jax_query_nbfnet_apply(setup.params["entity_model"], setup.jcfg.entity_model,
                                  setup.jgraph, jnp.asarray(boundary), jnp.asarray(rel_reprs),
                                  jnp.asarray(query))
    with torch.no_grad():
        got = query_nbfnet_apply(setup.model.entity_model, setup.graph,
                                 torch.from_numpy(boundary), torch.from_numpy(rel_reprs),
                                 torch.from_numpy(query))
    assert got.shape == (b, v)
    np.testing.assert_allclose(sigmoid(got.numpy()), sigmoid(want), rtol=0,
                               atol=PROB_ATOL_ONE_HOP)


@pytest.mark.parametrize("threshold", [0.0, 0.3])
@pytest.mark.parametrize("cached", [False, True])
def test_relation_projection_matches_jax(setup, threshold, cached):
    rng = np.random.default_rng(4)
    b, v, r = 4, setup.qg.num_nodes, setup.qg.num_relations
    h_prob = rng.random((b, v)).astype(np.float32)
    r_index = rng.integers(0, r, b)
    jq, pq = jexe.QueryConfig(threshold=threshold), exe.QueryConfig(threshold=threshold)
    jcache = jax_precompute(setup.params, setup.jcfg, setup.jgraph) if cached else None
    with torch.no_grad():
        pcache = (precompute_relation_representations(setup.model, setup.graph)
                  if cached else None)
        got = exe.relation_projection(setup.model, pq, setup.graph, torch.from_numpy(h_prob),
                                      torch.from_numpy(r_index), rel_reprs_all=pcache)
    want = jexe.relation_projection(setup.params, setup.jcfg, jq, setup.jgraph,
                                    jnp.asarray(h_prob), jnp.asarray(r_index.astype(np.int32)),
                                    rel_reprs_all=jcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PROB_ATOL_ONE_HOP)


def test_stack_matches_jax_at_a_clipped_pointer():
    """A push where the pointer is clipped keeps the other operand unless
    the mask is set; a pop moves only the masked pointers."""
    rng = np.random.default_rng(5)
    stack = rng.random((4, 2, 7)).astype(np.float32)
    sp = np.array([0, 1, 2, 3])
    mask = np.array([True, False, False, True])
    value = rng.random((4, 7)).astype(np.float32)
    got_stack, got_sp = exe.stack_push(torch.from_numpy(stack.copy()), torch.from_numpy(sp),
                                       torch.from_numpy(mask), torch.from_numpy(value))
    want_stack, want_sp = jexe.stack_push(jnp.asarray(stack), jnp.asarray(sp),
                                          jnp.asarray(mask), jnp.asarray(value))
    np.testing.assert_array_equal(got_stack.numpy(), np.asarray(want_stack))
    np.testing.assert_array_equal(got_sp.numpy(), np.asarray(want_sp))
    np.testing.assert_array_equal(got_stack.numpy()[2], stack[2])  # clipped, unmasked
    got_v, got_sp = exe.stack_pop(torch.from_numpy(stack), torch.from_numpy(sp),
                                  torch.from_numpy(mask))
    want_v, want_sp = jexe.stack_pop(jnp.asarray(stack), jnp.asarray(sp), jnp.asarray(mask))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_sp.numpy(), np.asarray(want_sp))


# -- the executors -----------------------------------------------------------


@pytest.mark.parametrize("one_way, logic", [(False, logic) for logic in LOGICS]
                         + [(True, "product")])
def test_executors_match_jax_on_every_betae_type(one_way, logic):
    """All 14 BetaE types in one batch, with a threshold: ``execute`` against
    the JAX package's, and ``execute_grouped`` against ``execute``; on a
    graph with inverse edges for each logic, and on one whose edges run one
    way, which pins the edges' orientation."""
    setup = get_setup(one_way)
    rng = np.random.default_rng(6)
    query, _ = betae_batch(rng, setup.qg.num_nodes, setup.qg.num_relations)
    kind, operand = ops.decompose(query)
    jq = jexe.QueryConfig(logic=logic, dropout_ratio=0.0, threshold=0.3)
    pq = exe.QueryConfig(logic=logic, dropout_ratio=0.0, threshold=0.3)
    want = jexe.execute(setup.params, setup.jcfg, jq, setup.jgraph, jnp.asarray(kind),
                        jnp.asarray(operand))
    round_of, has_proj, arg_slot, n_rounds = exe.projection_schedule(kind)
    assert n_rounds == 3
    with torch.no_grad():
        got = exe.execute(setup.model, pq, setup.graph, torch.from_numpy(kind),
                          torch.from_numpy(operand))
        grouped = exe.execute_grouped(
            setup.model, pq, setup.graph, torch.from_numpy(kind), torch.from_numpy(operand),
            torch.from_numpy(round_of), torch.from_numpy(has_proj),
            torch.from_numpy(arg_slot), n_rounds)
    assert got.shape == (len(TYPES), setup.qg.num_nodes)
    np.testing.assert_allclose(sigmoid(got.numpy()), sigmoid(want), rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(grouped.numpy(), got.numpy(), rtol=1e-5, atol=1e-6)
    # the forward functions: the same answers through their host plumbing
    fwd = trainer.make_query_forward_grouped(setup.model, pq)
    np.testing.assert_array_equal(fwd(setup.graph, kind, operand).numpy(), grouped.numpy())
    plain = trainer.make_query_forward(setup.model, pq)
    np.testing.assert_array_equal(plain(setup.graph, kind, operand).numpy(), got.numpy())


def test_grouped_forward_matches_jax_with_its_padding():
    """The JAX package's grouped forward pads rounds to a bucket (a 5-hop
    chain runs 6 rounds there); the port runs 5 and gives the same answers,
    with the relation cache as evaluation passes it. The JAX side runs what
    ``make_query_forward_grouped`` runs, the padded schedule through
    ``execute_grouped``, without its jit (which takes a minute to compile
    here)."""
    setup, logic = get_setup(True), "godel"
    rng = np.random.default_rng(9)
    v, r = setup.qg.num_nodes, setup.qg.num_relations
    chain = [int(rng.integers(v))] + [ops.PROJECTION | int(rng.integers(r)) for _ in range(5)]
    progs = [np.array(chain + [ops.STOP], np.int64),
             jops.from_nested(instantiate(TYPES["pin"], rng, v, r))]
    kind, operand = ops.decompose(ops.pad_queries(progs, 8))
    jq = jexe.QueryConfig(logic=logic, dropout_ratio=0.0, threshold=0.3)
    pq = exe.QueryConfig(logic=logic, dropout_ratio=0.0, threshold=0.3)
    assert exe.projection_schedule(kind)[3] == 5 and jexe.bucket_rounds(5) == 6
    jcache = jax_precompute(setup.params, setup.jcfg, setup.jgraph)
    round_of, has_proj, arg_slot, n_rounds = jexe.projection_schedule(kind)
    has_proj, arg_slot, n_rounds, _ = jexe.pad_round_schedule(has_proj, arg_slot, n_rounds)
    assert n_rounds == 6
    want = jexe.execute_grouped(setup.params, setup.jcfg, jq, setup.jgraph, jnp.asarray(kind),
                                jnp.asarray(operand), jnp.asarray(round_of),
                                jnp.asarray(has_proj), jnp.asarray(arg_slot), n_rounds,
                                rel_reprs_all=jcache)
    with torch.no_grad():
        pcache = precompute_relation_representations(setup.model, setup.graph)
    got = trainer.make_query_forward_grouped(setup.model, pq)(setup.graph, kind, operand,
                                                              pcache)
    np.testing.assert_allclose(sigmoid(got.numpy()), sigmoid(want), rtol=0, atol=PROB_ATOL)


def test_schedules_match_jax():
    rng = np.random.default_rng(7)
    query, _ = betae_batch(rng, 30, 8)
    chain = np.array([3] + [ops.PROJECTION | 1] * 5 + [ops.STOP], np.int64)
    for batch in (query, ops.pad_queries([chain, chain], 8), query[:0]):
        kind = ops.decompose(batch)[0]
        got, want = exe.projection_schedule(kind), jexe.projection_schedule(kind)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        _, has_proj, arg_slot, n_rounds = got
        graphs = ["g"] * n_rounds if n_rounds else None
        for a, b in zip(exe.pad_round_schedule(has_proj, arg_slot, n_rounds, graphs),
                        jexe.pad_round_schedule(has_proj, arg_slot, n_rounds, graphs)):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    assert [exe.bucket_rounds(n) for n in range(20)] == [jexe.bucket_rounds(n)
                                                         for n in range(20)]


def test_unknown_logic_is_refused():
    x = torch.zeros(2)
    with pytest.raises(ValueError, match="fuzzy logic"):
        exe.conjunction("boolean", x, x)
    with pytest.raises(ValueError, match="fuzzy logic"):
        exe.disjunction("boolean", x, x)


# -- the query graph and evaluation -----------------------------------------


def test_prepare_query_graph_keeps_the_edges_as_jax():
    """No inverse edges added, row 0 the destination, the relation graph's
    edge set equal to the JAX package's."""
    qg = query_graph(one_way=True)
    graph = trainer.prepare_query_graph(qg, device="cpu")
    jgraph = jtrainer.prepare_query_graph(qg, with_plans=False)
    e = qg.edge_index.shape[1]
    assert graph.num_edges_padded == e and graph.num_relations == qg.num_relations
    np.testing.assert_array_equal(graph.edge_index.numpy(), qg.edge_index)
    np.testing.assert_array_equal(np.asarray(jgraph.edge_index)[:, :e], qg.edge_index)

    def edge_set(g):
        w = np.asarray(g.edge_weight) != 0
        ei, et = np.asarray(g.edge_index)[:, w], np.asarray(g.edge_type)[w]
        return set(zip(ei[0].tolist(), ei[1].tolist(), et.tolist()))

    assert edge_set(graph.relation_graph) == edge_set(jgraph.relation_graph)


def test_evaluate_queries_matches_jax():
    ds = toy_query_dataset()
    jcfg, pcfg = configs()
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(0)))
    model = Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    names = ("mrr", "hits@1", "hits@3", "hits@10", "mape", "spearmanr", "auroc")
    (_, _), (_, _), (lo, hi) = ds.split_ranges()
    idx = np.arange(0, hi)  # every split's queries: 12, in batches of 5
    for threshold in (0.8,):  # the config's; the projection test holds 0 too
        want = jtrainer.evaluate_queries(
            params, jcfg, jexe.QueryConfig(threshold=threshold),
            jtrainer.prepare_query_graph(ds.graphs[2], with_plans=False), ds, idx,
            batch_size=5, metric_names=names)
        got = trainer.evaluate_queries(
            model, exe.QueryConfig(threshold=threshold),
            trainer.prepare_query_graph(ds.graphs[2], device="cpu"), ds, idx, batch_size=5,
            metric_names=names)
        assert list(got) == list(want)
        np.testing.assert_allclose(np.array(list(got.values())),
                                   np.array(list(want.values())), rtol=0, atol=1e-6)


def test_evaluate_queries_on_a_loaded_dataset_with_restricted_nodes(tmp_path):
    """The inductive fixture's test split (``restrict_nodes`` set) through
    both packages' loaders and evaluations."""
    root = str(tmp_path)
    write_inductive_fixture(root)
    ds = qds.build_query_dataset("InductiveFB15k237Query", root, version=9999).load()
    jds_ = jds.build_query_dataset("InductiveFB15k237Query", root, version=9999).load()
    jcfg, pcfg = configs()
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(1)))
    model = Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    (_, _), (_, _), (lo, hi) = ds.split_ranges()
    restrict = ds.graphs[2].restrict_nodes
    want = jtrainer.evaluate_queries(
        params, jcfg, jexe.QueryConfig(), jtrainer.prepare_query_graph(jds_.graphs[2]),
        jds_, np.arange(lo, hi), batch_size=2, restrict_nodes=restrict)
    got = trainer.evaluate_queries(
        model, exe.QueryConfig(), trainer.prepare_query_graph(ds.graphs[2], device="cpu"),
        ds, np.arange(lo, hi), batch_size=2, restrict_nodes=restrict)
    np.testing.assert_allclose(np.array(list(got.values())), np.array(list(want.values())),
                               rtol=0, atol=1e-6)


def test_evaluate_queries_refuses_a_process_group(monkeypatch):
    monkeypatch.setattr(trainer, "_process_group_size", lambda: 2)
    ds = toy_query_dataset()
    _, pcfg = configs()
    with pytest.raises(NotImplementedError, match="A12"):
        trainer.evaluate_queries(Ultra(pcfg), exe.QueryConfig(), None, ds, np.arange(2), 2)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, the query graph and the command line's run, called
    without a device, raise instead of running on the CPU."""
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.prepare_query_graph(query_graph())
    spec = importlib.util.spec_from_file_location(
        "torch_run_query", os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                                        "torch_run_query.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run({"train": {"num_epoch": 0}})
