"""Tests of the benchmark: ``python -m pytest benchmark/tests -q`` from the
root of the repository. Tests marked ``card`` need a CUDA card and skip
without one; they decide that inside the test, never at import."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
    import torch

    # several workers share the machine's cores: a few threads each
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the serving cell: its files are under benchmark/, its entry is not in
# BENCHMARK.json (the host's speed swings too widely for a bound; PERF.md,
# Open questions). The tests keep it ready.
SERVE = {"name": "ultraquery.serve.fb237_betae", "config": "ultraquery",
         "traffic": "serve.fb237_betae", "chips": 1}


def spec() -> dict:
    """``BENCHMARK.json`` with the serving cell's entry."""
    from benchmark.harness import cells

    s = copy.deepcopy(cells.benchmark_spec())
    if SERVE["name"] not in {w["name"] for w in s["workloads"]}:
        s["workloads"].append(SERVE)
    return s


def tiny_cell(name: str, limits: dict | None = None) -> dict:
    """Cell ``name`` of :func:`spec` at a size the CPU runs in seconds: the
    same files, the graph, the pool and the samples cut."""
    from benchmark.harness import cells

    c = copy.deepcopy(cells.cell(name, spec()))
    t = c["traffic"]
    if t["driver"] == "rank":
        t["graph"].update(entities=300, direct_relations=5, splits=[900, 24, 24], categories=0)
        t.update(chunk=8, warmup_triples=8, check_triples=8)
    else:
        t["graph"].update(entities=300, direct_relations=6, splits=[1000, 50, 50],
                          categories=0)
        t.update(queries_per_type=4, warmup_requests=1, check_requests=3)
    if limits is not None:
        c["limits"] = limits
    return c


@pytest.fixture
def tiny():
    return tiny_cell
