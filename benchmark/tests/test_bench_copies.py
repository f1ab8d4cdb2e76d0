"""The benchmark's frozen copies give what the port's originals give, at
seed 0 and small sizes, wherever their settings agree."""

import pickle

import numpy as np
import pytest
import torch

from benchmark.data import betae, bounds, kg


@pytest.mark.parametrize("kw", [dict(), dict(rel_dist="zipf"), dict(rel_dist="zipf", categories=5)])
def test_random_kg_triples_and_inverses(kw):
    from ultra_tpu_torch.data import synthetic

    want = synthetic.random_kg_triples(400, 7, 1200, seed=0, **kw)
    got = kg.random_kg_triples(400, 7, 1200, seed=0, **kw)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(kg.with_inverses(got, 7), synthetic.with_inverses(want, 7)):
        np.testing.assert_array_equal(a, b)


def test_split_triples_are_the_generators_shuffled():
    graph = dict(entities=400, direct_relations=7, splits=[1000, 50, 50], rel_dist="zipf",
                 categories=0, graph_seed=0)
    train, valid, test = kg.split_triples(graph)
    trip = kg.random_kg_triples(400, 7, 1100, seed=0, rel_dist="zipf")
    whole = np.concatenate([train, valid, test])
    assert [len(train), len(valid), len(test)] == [1000, 50, 50]
    assert {tuple(t) for t in whole} == {tuple(t) for t in trip}


def test_betae_sampler_draws_the_originals_queries(tmp_path):
    from ultra_tpu_torch.data import synthetic_queries as original

    types = tuple(betae.TYPE2STRUCT)
    assert betae.TYPE2STRUCT == {t: original.TYPE2STRUCT[t] for t in types}
    original.write_betae_dataset(str(tmp_path), "q", num_nodes=300, num_direct_rel=6,
                                 num_triples=1500, queries_per_type=1,
                                 train_queries_per_type=6, types=types, train_types=types,
                                 seed=0, categories=0)
    with open(tmp_path / "q" / "train-queries.pkl", "rb") as f:
        want = pickle.load(f)
    # write_betae_dataset's own draws: the triples, then the split's permutation
    trip = synthetic_triples = original.random_kg_triples(300, 6, 1500, seed=0, rel_dist="zipf")
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(synthetic_triples))
    train = trip[perm[:int(len(trip) * 0.96)]]
    adj = betae.Adj(*betae.betae_edges(train), 300, 12)
    got = betae.sample_queries(adj, types, 6, rng)
    assert {betae.TYPE2STRUCT[t]: set(q) for t, q in got.items()} == want
    # the adjacency's lookups list a node's edges as the original's scans do
    old = original._Adj(*betae.betae_edges(train), 300, 12)
    for node in range(0, 300, 7):
        for fn in ("rels_from", "rels_into"):
            a, b = np.random.default_rng(node), np.random.default_rng(node)
            assert getattr(adj, fn)(node, a) == getattr(old, fn)(node, b)


def test_rspmm_bound_is_benchlibs():
    from ultra_tpu_torch.graph import make_graph
    from ultra_tpu_torch.utils import benchlib

    trip = kg.random_kg_triples(200, 5, 600, seed=0)
    ei, et = kg.with_inverses(trip, 5)
    graph = make_graph(ei, et, 200, 10, device="cpu")
    for feat, dtype, tag in ((64, torch.float32, "f32"), (512, torch.bfloat16, "bf16")):
        x = torch.zeros(200, feat, dtype=dtype)
        rel = torch.zeros(10, feat, dtype=dtype)
        want = benchlib.rspmm_bound_ms(graph.csr, graph.edge_weight, rel, x)
        e = graph.csr.col.numel()
        got = bounds.rspmm_bound_ms(200, 200, 10, e, e, feat, tag, tag)
        assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)
    assert (bounds.H100_BYTES_PER_S, bounds.H100_F32_FLOPS) == (
        benchlib.H100_BYTES_PER_S, benchlib.H100_F32_FLOPS)
