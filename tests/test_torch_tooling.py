"""The port's tooling against the JAX package's: the dataset zoo
(``ultra_tpu_torch/data/zoo.py``), ``utils/config.py::literal_eval_flags``,
profiling (``utils/profiling.py``), the supervisor
(``scripts/torch_supervise.py``) and the two parity command lines
(``scripts/torch_parity_run.py``, ``scripts/torch_parity_run_query.py``).

Tolerances: the zoo's tables, targets and staging answers, the flags and
the step timer's arithmetic must be equal. The parity rows come from the
two packages' zero-shot runs on the same toy fixtures (those of
``tests/test_cli.py``) from the same random weights (the JAX package's
``init_ultra_params``, written with its ``export_ultra_checkpoint``): each
row's MRR and Hits@10 (rounded to 4 digits by both scripts) within 1e-4,
and the same rows skipped.
"""

import importlib.util
import json
import os
import runpy
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from tests.test_query_datasets import write_transductive_fixture
from ultra_tpu.data import zoo as jzoo
from ultra_tpu.models.nbfnet import UltraConfig as JUltraConfig
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu.utils import config as jconfig
from ultra_tpu.utils import profiling as jprofiling
from ultra_tpu.utils.torch_ckpt import export_ultra_checkpoint
from ultra_tpu_torch.data import kg, zoo
from ultra_tpu_torch.query import datasets as qds
from ultra_tpu_torch.utils import config, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


# ---------------------------------------------------------------- the zoo


def test_zoo_tables_equal_the_jax_zoo():
    assert zoo.GROUPS == jzoo.GROUPS
    assert zoo.QUERY_GROUPS == jzoo.QUERY_GROUPS
    assert zoo.INDUCTIVE_CLASSES == jzoo.INDUCTIVE_CLASSES
    assert zoo.QUERY_SENTINEL == jzoo.QUERY_SENTINEL
    # every member names a class the port has
    for name, _ in zoo.GROUPS["all"] + zoo.GROUPS["pretrain4g"]:
        assert name in kg.DATASETS, name
    for name, _ in zoo.QUERY_GROUPS["query_all"]:
        assert name in qds.QUERY_DATASETS and name in zoo.QUERY_SENTINEL, name
    assert zoo.INDUCTIVE_CLASSES <= set(kg.DATASETS)


@pytest.mark.parametrize("spec", [
    "inductive_e,inductive_er", "FB15k237,WN18RR", "HM:1k, FBIngram:50,,all",
    "query_all", "query_transductive,InductiveFB15k237Query:550,WikiTopicsQuery:art",
    "pretrain3g,pretrain4g,transductive",
])
def test_iter_targets_and_names(spec):
    got = list(zoo.iter_targets(spec))
    assert got == list(jzoo.iter_targets(spec))
    assert [zoo.target_name(n, v) for n, v in got] == [jzoo.target_name(n, v) for n, v in got]
    assert ([zoo.is_query_dataset(n) for n, _ in got]
            == [jzoo.is_query_dataset(n) for n, _ in got])


def test_staging_answers_equal_the_jax_zoo(tmp_path):
    """On a root where FB15k237 has raw files, HM:1k a cache only, WN18RR
    two of its three files and the rest nothing; and a query root with
    FB15k237LogicalQuery staged."""
    root = tmp_path / "kg"
    for name, files in (("fb15k237", ("train.txt", "valid.txt", "test.txt")),
                        ("wn18rr", ("train.txt", "valid.txt"))):
        (root / name / "raw").mkdir(parents=True)
        for f in files:
            (root / name / "raw" / f).write_text("a r b\n")
    hm = zoo.instantiate("HM", "1k", str(root))
    os.makedirs(os.path.dirname(hm.processed_path))
    open(hm.processed_path, "w").close()
    targets = [("FB15k237", None), ("WN18RR", None), ("HM", "1k"), ("HM", "3k"),
               ("FBIngram", "25"), ("CoDExSmall", None)]
    got = [zoo.is_staged(n, v, str(root)) for n, v in targets]
    assert got == [jzoo.is_staged(n, v, str(root)) for n, v in targets]
    assert got == [True, False, True, False, False, False]
    assert type(zoo.instantiate("FB15k237", None, str(root))) is kg.DATASETS["FB15k237"]

    qroot = tmp_path / "q"
    write_transductive_fixture(str(qroot), name="FB15k-237-betae")
    qtargets = jzoo.QUERY_GROUPS["query_all"]
    got = [zoo.query_is_staged(n, v, str(qroot)) for n, v in qtargets]
    assert got == [jzoo.query_is_staged(n, v, str(qroot)) for n, v in qtargets]
    assert got.count(True) == 1 and got[0] is True
    assert ([zoo.query_archive_url(n, v, str(qroot)) for n, v in qtargets]
            == [jzoo.query_archive_url(n, v, str(qroot)) for n, v in qtargets])


# ------------------------------------------------------------- config flags


@pytest.mark.parametrize("value", [
    "null", "None", "1", "-2.5e-3", "[0, 1]", "{'a': (1, 2)}", "yes", "True", "./path/x.pth",
    "1 +", "", "'quoted'", 7, None, [1, "2"],
])
def test_literal_eval_flags(value):
    flags = {"flag": value, "other": "3"}
    assert config.literal_eval_flags(flags) == jconfig.literal_eval_flags(flags)


# ---------------------------------------------------------------- profiling


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("tooling_region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "tooling_region" for e in events)
    assert any(e.key == "tooling_region" for e in prof.key_averages())


class FakeClock:
    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


@pytest.mark.parametrize("edges", [None, 544_230])
def test_step_timer_arithmetic(edges, monkeypatch):
    """The same clock readings give the JAX timer's step times, mean,
    edges/s and summary; the window keeps the last steps; a CPU tensor's
    sync reads the clock and nothing more."""
    clock = [0.0, 0.010, 1.0, 1.030, 2.0, 2.005, 3.0, 3.020]
    timers = {}
    for name, module in (("port", profiling), ("jax", jprofiling)):
        monkeypatch.setattr(module.time, "perf_counter", FakeClock(clock))
        timer = module.StepTimer(window=3, edges_per_step=edges)
        steps = []
        for _ in range(4):
            timer.start()
            steps.append(timer.stop(sync=torch.ones(2) if name == "port" else None))
        timers[name] = (timer, steps)
        monkeypatch.undo()
    (port, port_steps), (jx, jax_steps) = timers["port"], timers["jax"]
    assert port_steps == jax_steps
    assert list(port.times) == list(jx.times) == jax_steps[1:]
    assert port.mean_step_s == jx.mean_step_s == pytest.approx(0.055 / 3)
    assert port.edges_per_sec == jx.edges_per_sec
    assert port.summary() == jx.summary()
    assert (port.edges_per_sec is None) == (edges is None)
    empty = profiling.StepTimer()
    assert empty.mean_step_s == 0.0 and empty.edges_per_sec is None


# --------------------------------------------------------------- supervisor


def load_supervise():
    spec = importlib.util.spec_from_file_location("torch_supervise",
                                                  os.path.join(SCRIPTS, "torch_supervise.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHILD = """
import os, sys
work = os.environ["ULTRA_WORKDIR"]
runs = os.path.join(work, "runs")
n = len(open(runs).read()) if os.path.exists(runs) else 0
open(runs, "a").write("x")
print("resume:", os.environ.get("ULTRA_RESUME_FROM"))
mode = sys.argv[1]
if mode == "always":
    sys.exit(3)
if n == 0:
    if mode == "crash_after_checkpoint":
        open(os.path.join(work, "model_latest.pth"), "w").write("ckpt")
    sys.exit(1)  # simulated crash
assert os.environ.get("ULTRA_RESUME_FROM", "").endswith("model_latest.pth") == (
    mode == "crash_after_checkpoint"), os.environ.get("ULTRA_RESUME_FROM")
print("resumed ok")
"""


def supervise(tmp_path, mode, restarts=2):
    work = tmp_path / "w"
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_supervise.py"), "--workdir", str(work),
         "--max-restarts", str(restarts), "--no-probe", "--", sys.executable, str(child), mode],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, SUPERVISE_MAX_BACKOFF="0"))
    return proc, work


@pytest.mark.parametrize("mode", ["crash_after_checkpoint", "crash_before_checkpoint"])
def test_supervise_restarts_and_resumes(tmp_path, mode):
    """A crashed child is restarted; ULTRA_RESUME_FROM points at
    <workdir>/model_latest.pth once it exists, and the final rc 0 is
    propagated."""
    proc, work = supervise(tmp_path, mode)
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert "resumed ok" in proc.stdout
    assert (work / "runs").read_text() == "xx"
    if mode == "crash_after_checkpoint":
        assert f"restart 1: resuming from {work / 'model_latest.pth'}" in proc.stderr
        assert f"resume: {work / 'model_latest.pth'}" in proc.stdout
    else:
        assert "restart 1: no crash checkpoint yet, fresh start" in proc.stderr
    assert "command completed" in proc.stderr


def test_supervise_exhausts_its_budget(tmp_path):
    proc, work = supervise(tmp_path, "always", restarts=2)
    assert proc.returncode == 3
    assert (work / "runs").read_text() == "xxx"  # the first run and 2 restarts
    assert "restart budget exhausted" in proc.stderr


def test_probe_reports_a_hung_or_absent_card_down(monkeypatch):
    """A probe that hangs past its timeout reports the card down, and the
    real probe never passes without a card."""
    sup = load_supervise()
    monkeypatch.setattr(sup, "PROBE", "import time; time.sleep(60)")
    t0 = time.monotonic()
    assert not sup.backend_up(timeout=2)
    assert time.monotonic() - t0 < 30
    assert not sup.wait_for_backend(probe_timeout=2, poll_s=0, max_wait_s=0)
    monkeypatch.undo()
    assert sup.backend_up(timeout=120) == torch.cuda.is_available()


def test_supervise_waits_for_the_card_and_gives_up(tmp_path):
    """Without a card the probe is down, and with no wait budget left the
    supervisor exits 75 without running the command."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe reports it up")
    marker = tmp_path / "ran"
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_supervise.py"), "--workdir",
         str(tmp_path / "w"), "--backend-max-wait", "0", "--probe-timeout", "120", "--",
         sys.executable, "-c", f"open({str(marker)!r}, 'w')"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 75
    assert "backend never came up" in proc.stderr and not marker.exists()


# -------------------------------------------------------------- parity twins


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """ultra_3g's random weights from the JAX package, as a reference-layout
    .pth and in UltraQuery's model.model.* layout."""
    base = tmp_path_factory.mktemp("parity_ckpt")
    params = jax.device_get(jax_init_ultra_params(JUltraConfig(), jax.random.key(11)))
    paths = {"ultra": str(base / "ultra_3g.pth"), "query": str(base / "ultraquery.pth")}
    export_ultra_checkpoint(params, paths["ultra"])
    export_ultra_checkpoint(params, paths["query"], nest_levels=2)
    return paths


def write_kg_fixture(root):
    """tests/test_cli.py::test_parity_run_cli's toy raw files at FB15k237's
    and WN18RR's paths."""
    rng = np.random.default_rng(3)
    for name in ("fb15k237", "wn18rr"):
        raw = root / name / "raw"
        raw.mkdir(parents=True)
        lines = sorted({f"e{rng.integers(14)}\tr{rng.integers(4)}\te{rng.integers(14)}"
                        for _ in range(90)})
        (raw / "train.txt").write_text("\n".join(lines[:60]) + "\n")
        (raw / "valid.txt").write_text("\n".join(lines[60:75]) + "\n")
        (raw / "test.txt").write_text("\n".join(lines[75:88]) + "\n")


def run_both(tmp_path, script, args):
    """The JAX script (through a launcher, as tests/test_cli.py runs it) and
    the port's twin with --device cpu, each in its own process and
    directory, at once; returns {side: (returncode, last line, stderr)}."""
    procs = {}
    for side in ("jax", "port"):
        cwd = tmp_path / side
        cwd.mkdir()
        if side == "jax":
            launcher = cwd / "launch.py"
            launcher.write_text(
                f"import sys\nsys.path.insert(0, {REPO!r})\nimport tests.conftest\n"
                f"sys.argv = {[script + '.py', *args]!r}\n"
                f"exec(open({os.path.join(SCRIPTS, script + '.py')!r}).read())\n")
            cmd = [sys.executable, str(launcher)]
        else:
            cmd = [sys.executable, os.path.join(SCRIPTS, f"torch_{script}.py"), *args,
                   "--device", "cpu"]
        procs[side] = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    out = {}
    for side, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (side, stderr[-3000:])
        out[side] = (json.loads(stdout.strip().splitlines()[-1]), stderr)
    return out


def assert_rows_match(port, jax_rows, keys):
    assert [r["dataset"] for r in port] == [r["dataset"] for r in jax_rows]
    for p, j in zip(port, jax_rows):
        assert "error" not in p and "error" not in j
        for k in keys:
            assert np.isclose(p[k], j[k], rtol=0, atol=1e-4, equal_nan=True), (
                p["dataset"], k, p[k], j[k])


def test_parity_run_twin_matches_jax(tmp_path, checkpoints):
    root = tmp_path / "kg-datasets"
    write_kg_fixture(root)
    out = run_both(tmp_path, "parity_run",
                   ["-d", "FB15k237,WN18RR,CoDExSmall", "--ckpt", checkpoints["ultra"],
                    "--root", str(root), "--output", "parity.csv"])
    (port, port_err), (jx, jax_err) = out["port"], out["jax"]
    assert_rows_match(port["rows"], jx["rows"], ("mrr", "hits@10"))
    assert {r["dataset"] for r in port["rows"]} == {"FB15k237", "WN18RR"}
    for err in (port_err, jax_err):
        assert "missing raw data for 1 dataset(s): CoDExSmall" in err
    assert port["precision"] == jx["precision"] == "highest"
    assert port["groups"] == jx["groups"] == {}  # neither group ran a member
    csv_lines = (tmp_path / "port" / "parity.csv").read_text().splitlines()
    assert csv_lines[0] == "dataset,mrr,hits@10,time_s,error" and len(csv_lines) == 3
    assert len(list((tmp_path / "port").glob("parity_report_*.json"))) == 1


def test_parity_run_query_twin_matches_jax(tmp_path, checkpoints):
    root = tmp_path / "query-datasets"
    write_transductive_fixture(str(root), name="FB15k-237-betae")
    out = run_both(tmp_path, "parity_run_query",
                   ["-d", "FB15k237LogicalQuery,NELL995LogicalQuery", "--ckpt",
                    checkpoints["query"], "--root", str(root), "--bs", "4",
                    "--output", "parity_q.csv"])
    (port, port_err), (jx, jax_err) = out["port"], out["jax"]
    assert [r["dataset"] for r in port["rows"]] == ["FB15k237LogicalQuery"]
    assert_rows_match(port["rows"], jx["rows"],
                      ("epfo_mrr", "epfo_hits@10", "neg_mrr", "neg_hits@10"))
    for err in (port_err, jax_err):
        assert "missing raw data for 1 query dataset(s): NELL995LogicalQuery" in err
    assert port["groups"].keys() == jx["groups"].keys() == {"query_all", "query_transductive"}
    for group, entry in port["groups"].items():
        assert abs(entry["epfo_mrr"] - jx["groups"][group]["epfo_mrr"]) <= 1e-4
        assert not entry["complete"]
    assert (tmp_path / "port" / "parity_q.csv").exists()


def run_in_process(script, args, cwd, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [script, *args, "--device", "cpu"])
    runpy.run_path(os.path.join(SCRIPTS, script), run_name="__main__")
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_parity_twins_record_data_errors_and_raise_model_errors(tmp_path, checkpoints,
                                                                 monkeypatch, capsys):
    """A dataset whose files fail to load gets an error row and the sweep
    goes on; a checkpoint that does not fit the model ends the run."""
    root = tmp_path / "kg-datasets"
    write_kg_fixture(root)
    (root / "wn18rr" / "raw" / "test.txt").write_text("only two\n")  # a malformed line
    report = run_in_process("torch_parity_run.py",
                            ["-d", "WN18RR,FB15k237", "--ckpt", checkpoints["ultra"],
                             "--root", str(root)], tmp_path, monkeypatch, capsys)
    rows = report["rows"]
    assert [r["dataset"] for r in rows] == ["WN18RR", "FB15k237"]
    assert set(rows[0]) == {"dataset", "error"} and "mrr" in rows[1]

    bad = tmp_path / "bad.pth"
    torch.save({"model": {"entity_model.query.weight": torch.zeros(3)}}, bad)
    with pytest.raises(RuntimeError):
        run_in_process("torch_parity_run.py", ["-d", "FB15k237", "--ckpt", str(bad),
                                                "--root", str(root)],
                       tmp_path, monkeypatch, capsys)
    qroot = tmp_path / "query-datasets"
    write_transductive_fixture(str(qroot), name="FB15k-237-betae")
    with pytest.raises(RuntimeError):
        run_in_process("torch_parity_run_query.py",
                       ["-d", "FB15k237LogicalQuery", "--ckpt", str(bad), "--root", str(qroot)],
                       tmp_path, monkeypatch, capsys)
    with pytest.raises(SystemExit):  # the port's kernels run exact f32 only
        run_in_process("torch_parity_run.py", ["--ckpt", "null", "--precision", "default"],
                       tmp_path, monkeypatch, capsys)
