"""Nothing under ``benchmark/`` imports JAX, the JAX package or the TPU
benchmark, and the harness finds every cell, configuration, traffic mix
and metric of ``BENCHMARK.json`` by name."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark.harness import cells, runner

FILES = sorted(p for p in cells.BENCH_DIR.rglob("*.py"))


def imported(path) -> set:
    """The top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(cells.ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported(path) & set(runner.FORBIDDEN)


def test_top_level_names_compare_whole():
    assert "ultra_tpu" in runner.FORBIDDEN and not {"ultra_tpu_torch", "benchmark"} & set(
        runner.FORBIDDEN)


def test_a_run_loads_no_forbidden_module():
    """Every module of the benchmark and every driver and reader (the
    serving cell's, kept ready, too), imported in a fresh process, with
    what they import of the port."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import cells, runner\n"
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark.tests.conftest import spec\n"
        "spec = spec()\n"
        "[cells.cell(w['name'], spec) for w in spec['workloads']]\n"
        "[cells.driver(cells.cell(w['name'], spec)['traffic']['driver'])\n"
        " for w in spec['workloads']]\n"
        "[cells.reader(m['name']) for m in spec['per_layer']]\n"
        "import ultra_tpu_torch.train.eval, ultra_tpu_torch.server, ultra_tpu_torch.serve\n"
        "import ultra_tpu_torch.query.trainer\n"
        "print(runner.forbidden_modules())\n" % str(cells.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=cells.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


SPEC = cells.benchmark_spec()


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(name):
    c = cells.cell(name, SPEC)
    drv = cells.driver(c["traffic"]["driver"])
    for fn in ("setup", "window", "work", "end_to_end", "graphs", "release", "check"):
        assert callable(getattr(drv, fn))
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"} and len(c["end_to_end"]) >= 2
    assert c["per_layer"]
    assert c["config"]["name"] == c["workload"]["config"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(cells.reader(metric).read)


def test_config_files_and_entries_agree():
    for entry in SPEC["configs"]:
        path = cells.ROOT / entry["file"]
        cfg = json.loads(path.read_text())
        assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
        assert path.relative_to(cells.BENCH_DIR)


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    """A cell, a configuration, its limits and a metric added as files and
    entries: the harness finds them with no edit of a file that is there,
    and the cell runs (on the CPU, tiny) to correct under the limits of its
    own file."""
    from benchmark.tests.conftest import tiny_cell

    real = tiny_cell("ultra_3g.rank.yago310")
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (bench / sub).mkdir(parents=True)
    (bench / "drivers").symlink_to(cells.BENCH_DIR / "drivers")
    (bench / "configs" / "other.json").write_text(json.dumps(dict(real["config"],
                                                                  name="other")))
    (bench / "traffic" / "mix.json").write_text(json.dumps(real["traffic"]))
    (bench / "limits" / "other.mix.json").write_text(json.dumps(real["limits"]))
    (bench / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 1.0\n")
    spec = {"workloads": [{"name": "other.mix", "config": "other", "traffic": "mix",
                           "chips": 1}, {"name": "other.bare", "config": "other",
                                         "traffic": "mix", "chips": 1}],
            "end_to_end": [{"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "new_metric.mix", "workloads": ["other.mix"]}]}
    monkeypatch.setattr(cells, "BENCH_DIR", bench)
    c = cells.cell("other.mix", spec)
    assert c["config"]["name"] == "other" and c["traffic"]["driver"] == "rank"
    assert c["limits"] == real["limits"]
    assert cells.reader("new_metric.mix").read(None) == 1.0
    res = runner.run_cell("other.mix", 5, 0.5, False, device="cpu", cell=c)
    assert res["correct"], res["checks"]
    assert {k: ch["limit"] for k, ch in res["checks"].items()} == real["limits"]
    with pytest.raises(FileNotFoundError):
        cells.cell("other.bare", spec)  # no limits of its own: no cell


def test_benchmark_json_keeps_its_format():
    """The shapes the driver checks before a run: names, units, lengths,
    the keys of each entry, and that each per-layer metric's cells report
    the end-to-end metric it moves."""
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
        for e in SPEC[section]:
            assert set(e) - {"workloads"} == want, e
            assert name.match(e["name"])
            for text in ("why", "layer", "source"):
                if text in e and section in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
            if "unit" in e:
                assert unit.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    reports = {w["name"]: {m["name"] for m in cells.cell(w["name"], SPEC)["end_to_end"]}
               for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in reports[w], (m["name"], w)
    assert len(json.dumps(SPEC)) < 64 * 1024
