"""Device timing, the benchmark graph and the PNA configuration for
measurements on the card.

Counterpart of ``ultra_tpu/utils/benchlib.py`` and of the graph construction in
the root ``bench.py``. Used by ``chip_smoke.py`` and ``scripts/torch_*_profile.py``;
nothing on the serving path imports it.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from ultra_tpu_torch.data.kg import KGSplit
from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.models.nbfnet import NBFNetConfig, UltraConfig

# FB15k-237 shape: 14,541 entities; 272,115 train triples (544,230 edges with
# inverses); 237 direct relations, 474 with inverses.
FB15K237_NODES, FB15K237_TRIPLES, FB15K237_DIRECT_REL = 14541, 272115, 237

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit):
# HBM3 bandwidth, and f32 outside the tensor cores, which is the arithmetic
# of the rspmm.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


def fb15k237_split(kind: str = "realistic", seed: int = 0) -> KGSplit:
    """The FB15k-237-shaped synthetic graph of ``bench.py``: power-law
    entity popularity; ``"realistic"`` adds Zipf relation frequencies and 30
    entity categories, ``"uniform"`` draws relations uniformly. The targets
    are the direct triples."""
    kw = dict(rel_dist="zipf", categories=30) if kind == "realistic" else {}
    trip = random_kg_triples(FB15K237_NODES, FB15K237_DIRECT_REL, FB15K237_TRIPLES,
                             seed=seed, **kw)
    edge_index, edge_type = with_inverses(trip, FB15K237_DIRECT_REL)
    return KGSplit(edge_index, edge_type, FB15K237_NODES, 2 * FB15K237_DIRECT_REL,
                   np.ascontiguousarray(trip[:, :2].T), trip[:, 2].copy())


def pna_config() -> UltraConfig:
    """The PNA configuration at ``ultra_3g`` widths
    (``scripts/exp_pna_train.py:81-88``): a 6x64 sum RelNBFNet and a 6x64
    EntityNBFNet with projected relations, distmult messages and PNA
    aggregation, whose layers' ``linear`` takes 13 * 64 features."""
    dims = (64,) * 6
    return UltraConfig(
        relation_model=NBFNetConfig(input_dim=64, hidden_dims=dims, num_relation=4),
        entity_model=NBFNetConfig(input_dim=64, hidden_dims=dims, num_relation=1,
                                  project_relations=True, aggregate_func="pna"),
    )


def device_ms(fn, samples: int = 20, inner: int = 10) -> float:
    """Median device milliseconds per call of ``fn`` over ``samples`` runs
    of ``inner`` calls each, after warm-up, timed with CUDA events.

    A sleep kernel queued ahead of each run lets the host enqueue all
    ``inner`` calls before the first starts, so the events time the device
    and not the Python that launches the work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)
