"""The benchmark's arithmetic against hand counts: the model's operations,
a launch's least time, and the trace's busy time, gaps and labels."""

import pytest

from benchmark.data import bounds, flops
from benchmark.harness.trace import Trace

# a 4-node graph: 5 live edges of 3 relation types; its graph of relations
# has 3 nodes and 7 edges
NODES, EDGES, RELS = 4, 5, 3
TINY = {"relation_model": {"input_dim": 2, "hidden_dims": [2, 2]},
        "entity_model": {"input_dim": 2, "hidden_dims": [2, 2], "project_relations": True,
                         "num_mlp_layer": 2}}


def test_relation_query_flops_by_hand():
    # a layer: rspmm 3 * 7 edges * 2 features = 42; linear 2 * 3 rows * 4 in * 2 out = 48
    assert flops.relation_query_flops(TINY, 3, 7) == 2 * (42 + 48)


def test_entity_query_flops_by_hand():
    # a layer: rspmm 3 * 5 * 2 = 30; linear 2 * 4 * 4 * 2 = 64; projection of 3 relations,
    # two 2x2 products: 2 * 2 * 3 * 2 * 2 = 48. The MLP on 4 nodes: 4 -> 4 -> 1:
    # 2 * 4 * (4 * 4 + 4 * 1) = 160
    assert flops.entity_query_flops(TINY, NODES, EDGES, RELS) == 2 * (30 + 64 + 48) + 160
    assert flops.entity_query_flops(TINY, NODES, EDGES, RELS, score=False) == 2 * (30 + 64 + 48)


def test_ultra_3g_counts_match_the_issue():
    import json

    from benchmark.harness.cells import BENCH_DIR

    cfg = json.load(open(BENCH_DIR / "configs" / "ultra_3g.json"))
    # YAGO3-10 shape: 18.7 GFLOP a query (PERF.md)
    got = flops.entity_query_flops(cfg, 123182, 2158080, 74)
    assert got == pytest.approx(18.7e9, rel=0.01)


def test_rspmm_bound_by_hand():
    # 4 rows, F = 2, f32: x 4*2*4 = 32 B, relation 3*2*4 = 24, out 32, row pointers 8*5 = 40,
    # 16 B an edge = 80: 208 B; 3 * 5 * 2 = 30 operations
    ms, by = bounds.rspmm_bound_ms(NODES, NODES, RELS, EDGES, EDGES, 2)
    assert by == "bytes" and ms == pytest.approx(1e3 * 208 / 3.35e12)
    ms16, _ = bounds.rspmm_bound_ms(NODES, NODES, RELS, EDGES, EDGES, 2, "bf16", "bf16")
    assert ms16 == pytest.approx(1e3 * (208 - 28) / 3.35e12)
    assert bounds.bound_ms(0, 67e12)[0] == pytest.approx(1e3)


def test_trace_busy_gaps_and_labels():
    tr = Trace(10.0, device_ops=[("k1", 1.0, 3.0), ("k2", 2.0, 4.0), ("Memcpy HtoD", 6.0, 7.0)],
               host_ops=[("outer", 0.0, 10.0), ("inner", 4.5, 5.5), ("late", 8.0, 9.5)])
    assert tr.busy_intervals() == [(1.0, 4.0), (6.0, 7.0)]
    assert tr.busy_s == pytest.approx(4.0)
    assert tr.gaps() == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    assert [k[0] for k in tr.kernels] == ["k1", "k2"]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k1", 2.0]
    # the gaps' middles: 0.5 under "outer" alone, 5.0 under "inner", 8.5 under "late"
    assert dict(map(tuple, b["idle_gaps"])) == {"outer": 1.0, "inner": 2.0, "late": 3.0}
