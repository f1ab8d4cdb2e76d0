"""Runs one cell of the benchmark of ``ultra_tpu_torch`` once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its files are found by name (``harness/cells.py``). The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; last in it ``checks``, each number the comparison with the
reference took beside its limit, which also close standard error. Without
a CUDA card, with fewer cards than the cell asks for, or with JAX or the
JAX package loaded by the end of the run, it prints no result and exits 2.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness import cells, runner

    cell = cells.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             started=STARTED, cell=cell)
    found = runner.forbidden_modules()
    if found:
        print(f"run.py: modules loaded that the port must not load: {found}", file=sys.stderr)
        return 2
    print(json.dumps({"notes": result["notes"], "work": result["work"],
                      "launches": {k: {str(s): n for s, n in v.items()}
                                   for k, v in result["launches"].items()}}),
          file=sys.stderr)
    for name, ch in result["checks"].items():
        print(f"check {name} {ch['value']!r} limit {ch['limit']!r}", file=sys.stderr)
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
