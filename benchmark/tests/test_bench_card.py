"""On the card, each cell at its own size (and the serving cell kept
ready outside ``BENCHMARK.json``): under the control, the nearest
precision below its configuration's (float32 matrix products in TF32), a
run has to come out not correct where the same seed in float32 comes out
correct; and a traced run reads every per-layer metric of the cell. Skips
without a card."""

import pytest

from benchmark.harness import cells, runner
from benchmark.tests.conftest import SERVE, spec

CELLS = [w["name"] for w in cells.benchmark_spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS + [SERVE["name"]])
def test_the_tf32_control_fails_the_check(name, card):
    seed, c = 2**31 + 99, cells.cell(name, spec())
    sound = runner.run_cell(name, seed, 3.0, trace=False, device=card, cell=c)
    assert sound["correct"], sound["checks"]
    control = runner.run_cell(name, seed, 3.0, trace=False, device=card, control="tf32",
                              cell=c)
    assert not control["correct"], control["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_every_per_layer_metric(name, card):
    res = runner.run_cell(name, 2**31 + 98, 3.0, trace=True, device=card)
    want = {m["name"] for m in cells.cell(name)["per_layer"]}
    assert set(res["metrics"]) == want and res["correct"], (res["metrics"], res["checks"])
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
