"""B1's feature tiles on the card: the walk in slabs of x's columns
(``ops/rspmm_cuda.py::slab_tile``) against the walk in whole-row tiles.

A feature's sum depends on its own column alone, so a tile changes which
threads add, not the order of the additions: every tile must give the
whole-row walk's output bit for bit, in each of B1's three instances (f32;
bf16 relation and x rows; bf16 relation rows and the f32 output gradient,
the input gradient's), for both messages, on a power-law graph whose hub
rows take the second pass. The ranking cell's shape (a YAGO3-10-sized graph
at F = 1,024, where the rule slabs x) must give the same filtered ranks with
the rule as without it.

All tests are marked ``card`` and skip without a CUDA card. The file imports
no JAX, so that on the card it runs alone: ``python -m pytest
tests/test_torch_pieces_card.py -m card --noconftest -p no:cacheprovider``.
"""

import numpy as np
import pytest
import torch

from ultra_tpu_torch import tasks
from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models import nbfnet
from ultra_tpu_torch.ops import rspmm_cuda
from ultra_tpu_torch.tasks import build_relation_graph_arrays

# a budget no x of these tests exceeds: the whole-row geometry
WHOLE = 1 << 62


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _power_law_graph(card, nodes=3_000, rels=12, triples=60_000):
    trip = random_kg_triples(nodes, rels, triples, seed=5, rel_dist="zipf")
    ei, et = with_inverses(trip, rels)
    return make_graph(ei, et, nodes, 2 * rels, device=card)


def _tiles(width):
    """Every tile the walk supports that divides ``width``."""
    return [t for t in (8, 16, *range(32, 257, 32)) if t <= width and width % t == 0]


@pytest.mark.card
@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("instance", ["", "bf16_bf16", "bf16_f32"])
def test_slabs_equal_the_whole_row_walk(card, instance, mul):
    graph = _power_law_graph(card)
    # the input gradient's instance walks the CSR by source
    csr = graph.csr_src if instance == "bf16_f32" else graph.csr
    assert csr.long_rows.numel() > 0  # hub rows: the second pass runs
    gen = torch.Generator().manual_seed(len(instance) + len(mul))
    feat = 512
    rel_type = torch.float32 if instance == "" else torch.bfloat16
    x_type = torch.bfloat16 if instance == "bf16_bf16" else torch.float32
    rel = torch.randn(graph.num_relations, feat, generator=gen).to(card, rel_type)
    x = torch.randn(graph.num_nodes, feat, generator=gen).to(card, x_type)
    w = torch.rand(graph.edge_weight.shape, generator=gen).to(card) * graph.edge_weight
    name = rspmm_cuda._entry("rspmm_sum_fwd", instance)
    code = rspmm_cuda._MUL_CODE[mul]
    whole = rspmm_cuda._launch_sum(name, "rspmm_sum_fwd", csr, w, rel, x, code, budget=WHOLE)
    # a budget of 0 bytes: the rule slabs, in tiles of a warp
    slabbed = rspmm_cuda._launch_sum(name, "rspmm_sum_fwd", csr, w, rel, x, code, budget=0)
    torch.cuda.synchronize()
    assert torch.equal(slabbed, whole), (instance, mul)
    tiles = _tiles(feat // rspmm_cuda._FEATURES.get(name, 4))
    assert rspmm_cuda.SLAB_TILE in tiles and len(tiles) >= 4
    for tile in tiles:  # every tile the walk supports at this width
        got = rspmm_cuda._launch_pieces(name, "rspmm_sum_fwd", csr, w, rel, x, code, tile)
        torch.cuda.synchronize()
        assert torch.equal(got, whole), (instance, mul, tile)


@pytest.mark.card
def test_a_tile_the_walk_does_not_support_is_refused(card):
    graph = _power_law_graph(card, nodes=200, rels=4, triples=2_000)
    rel = torch.randn(graph.num_relations, 256, device=card)
    x = torch.randn(graph.num_nodes, 256, device=card)
    for tile in (4, 24, 48, 128):  # 128 is wider than the row's 64 units
        with pytest.raises(RuntimeError, match="CUDA error"):
            rspmm_cuda._launch_pieces("rspmm_sum_fwd", "rspmm_sum_fwd", graph.csr,
                                      graph.edge_weight, rel, x, 0, tile)


@pytest.mark.card
def test_collect_rankings_same_ranks_with_slabs(card, monkeypatch):
    """The ranking cell's graph (YAGO3-10's shape: 123,182 entities, 37
    relations, 1,079,040 triples) and pass (8 triples both ways: F = 1,024,
    an x of 504 MB): the same ranks with the rule's slabs as in whole rows."""
    from ultra_tpu_torch.train.eval import collect_rankings
    from ultra_tpu_torch.train.loop import init_ultra_params

    nodes, rels = 123_182, 37
    trip = random_kg_triples(nodes, rels, 1_079_040, seed=0, rel_dist="zipf", categories=30)
    ei, et = with_inverses(trip, rels)
    rei, ret = build_relation_graph_arrays(ei, et, nodes, 2 * rels)
    g = make_graph(ei, et, nodes, 2 * rels, device=card,
                   relation_graph=make_graph(rei, ret, 2 * rels, 4, device=card))
    index = tasks.GraphIndex.build(ei, et, nodes, 2 * rels)
    model = init_ultra_params(nbfnet.UltraConfig(), torch.Generator().manual_seed(0),
                              device=card).eval()
    trips = trip[:16]
    tiles = []
    launch = rspmm_cuda._launch_pieces

    def spy(name, op, csr, edge_weight, relation, x, *codes):
        tiles.append((x.shape[1], codes[-1]))
        return launch(name, op, csr, edge_weight, relation, x, *codes)

    monkeypatch.setattr(rspmm_cuda, "_launch_pieces", spy)
    slabbed = collect_rankings(model, g, trips, index, batch_size=8)
    assert (1024, 32) in tiles  # the entity passes walk 128-feature slabs
    monkeypatch.setattr(rspmm_cuda, "slab_budget", lambda l2_bytes: WHOLE)
    tiles.clear()
    whole = collect_rankings(model, g, trips, index, batch_size=8)
    assert (1024, 256) in tiles and all(t == rspmm_cuda.group_size(f // 4) for f, t in tiles)
    for a, b in zip(slabbed, whole, strict=True):
        np.testing.assert_array_equal(a, b)
