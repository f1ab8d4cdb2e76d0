"""Elastic supervisor for the PyTorch/CUDA port: restart a training command
across crashes and card outages. The twin of ``scripts/supervise.py``:

  python scripts/torch_supervise.py --workdir output/run1 --max-restarts 10 -- \
      python scripts/torch_run.py -c config/transductive/inference.yaml \
      --dataset FB15k237 --epochs 10 ...

- pins ``ULTRA_WORKDIR`` so every (re)start shares one working directory;
- on a restart, points ``ULTRA_RESUME_FROM`` at ``<workdir>/model_latest.pth``,
  the crash checkpoint the port's trainers write every
  ``train.checkpoint_interval_steps`` steps (weights, optimizer state and
  step; they resume from it, and ignore it while it is absent);
- before each (re)start, probes the card in a subprocess under a hard
  timeout (``torch.cuda.is_available()`` and a 64x64 matrix product on the
  card, synchronised) and waits, with bounded polling, while it is down; the
  probe never passes without a card. ``--no-probe`` skips it (CPU jobs);
- backs off exponentially between crash restarts (30 s, doubling, at most
  ``$SUPERVISE_MAX_BACKOFF`` seconds, 600 by default) and exits with the
  command's last exit code; 75 when the card never came up.
"""

import argparse
import os
import subprocess
import sys
import time

PROBE = (
    "import sys, torch\n"
    "if not torch.cuda.is_available():\n"
    "    sys.exit('no CUDA device')\n"
    "x = torch.ones(64, 64, device='cuda')\n"
    "s = float((x @ x).sum())\n"
    "torch.cuda.synchronize()\n"
    "print(torch.cuda.get_device_name(0), s)\n"
)


def log(*a):
    print("[supervise]", *a, file=sys.stderr, flush=True)


def backend_up(timeout: int) -> bool:
    """Whether a fresh process reaches the card and computes on it within
    ``timeout`` seconds."""
    try:
        proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return False
    return proc.returncode == 0


def wait_for_backend(probe_timeout: int, poll_s: int, max_wait_s: int) -> bool:
    waited = 0
    while not backend_up(probe_timeout):
        if waited >= max_wait_s:
            return False
        log(f"backend down; retrying in {poll_s}s (waited {waited}/{max_wait_s}s)")
        time.sleep(poll_s)
        waited += poll_s + probe_timeout
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--probe-timeout", type=int, default=180)
    ap.add_argument("--backend-poll", type=int, default=120)
    ap.add_argument("--backend-max-wait", type=int, default=6 * 3600)
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the card preflight (CPU jobs and tests)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="-- <command to supervise>")
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (append: -- python scripts/torch_run.py ...)")

    os.makedirs(args.workdir, exist_ok=True)
    ckpt = os.path.join(args.workdir, "model_latest.pth")
    env = dict(os.environ, ULTRA_WORKDIR=args.workdir)

    backoff = 30
    for attempt in range(args.max_restarts + 1):
        if not args.no_probe and not wait_for_backend(
            args.probe_timeout, args.backend_poll, args.backend_max_wait
        ):
            log("backend never came up within the wait budget")
            sys.exit(75)  # EX_TEMPFAIL
        if attempt and os.path.exists(ckpt):
            env["ULTRA_RESUME_FROM"] = ckpt
            log(f"restart {attempt}: resuming from {ckpt}")
        elif attempt:
            log(f"restart {attempt}: no crash checkpoint yet, fresh start")
        rc = subprocess.call(cmd, env=env)
        if rc == 0:
            log("command completed")
            sys.exit(0)
        log(f"command exited rc={rc}; backoff {backoff}s "
            f"({attempt + 1}/{args.max_restarts} restarts used)")
        if attempt == args.max_restarts:
            break
        time.sleep(min(backoff, int(os.environ.get("SUPERVISE_MAX_BACKOFF", "600"))))
        backoff = min(backoff * 2, 600)
    log("restart budget exhausted")
    sys.exit(rc)


if __name__ == "__main__":
    main()
