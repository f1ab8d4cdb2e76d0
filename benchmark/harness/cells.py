"""Everything a cell is made of, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files behind those names are:

- ``benchmark/configs/<config>.json``: the model's settings (and, for a
  model that answers queries, its query settings);
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters and the
  ``driver`` that generates it and calls the program;
- ``benchmark/limits/<cell>.json``: the limit of each number the comparison
  that decides ``correct`` takes in the cell (a cell without it is never
  correct);
- ``benchmark/drivers/<driver>.py``: a kind of traffic;
- ``benchmark/metrics/<metric>.py``, or for ``<name>.<part>`` the reader
  ``<name>.py`` when ``<metric>.py`` is not there: one per-layer metric.

A new cell, metric or configuration is new files and entries, and no edit
of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(name: str, spec: dict | None = None) -> dict:
    """The cell ``name``: its ``workload`` entry, ``config``, ``traffic``
    and ``limits`` files, and the end-to-end and per-layer metrics it
    reports."""
    spec = spec or benchmark_spec()
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    mine = lambda m: name in m.get("workloads", [name])  # noqa: E731
    return {
        "workload": entry,
        "config": load_json(BENCH_DIR / "configs" / f"{entry['config']}.json"),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        "limits": load_json(BENCH_DIR / "limits" / f"{name}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }


def driver(name: str) -> ModuleType:
    return _module(BENCH_DIR / "drivers" / f"{name}.py", name)


def reader(metric: str) -> ModuleType:
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``,
    else ``metrics/<part before the first dot>.py``."""
    own = BENCH_DIR / "metrics" / f"{metric}.py"
    path = own if own.exists() else BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"
    return _module(path, metric)
