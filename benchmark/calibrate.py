"""Readings of the numbers that decide ``correct``, for setting their limits.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --seconds 5 \\
        [--controls tf32,bf16] [--out chiprun_out/readings.jsonl]

On the card, in one process: for each seed a run of the cell as the
benchmark runs it (short window, no trace), then one run under each
control (``harness/program.py``: the program's float32 matrix products in
TF32, or its ``compute_dtype: bfloat16``), each checked against the
reference. One JSON line a run: seed, control, the compared numbers and
the check's notes, the window's end-to-end metrics. The benchmark's own
runs never run a control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()
sys.path[0] = str(Path(__file__).resolve().parents[1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--controls", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness import runner

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in [None] + [c for c in args.controls.split(",") if c]:
            t0 = time.perf_counter()
            res = runner.run_cell(args.workload, seed, args.seconds, False, control=control)
            line = json.dumps({"workload": args.workload, "seed": seed, "control": control,
                               "checks": {k: v["value"] for k, v in res["checks"].items()},
                               "notes": res["notes"], "metrics": res["metrics"],
                               "run_s": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
