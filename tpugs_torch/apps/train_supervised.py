"""Crash-resilient training supervisor: run -> detect failure -> resume.
Counterpart: ``scripts/train_supervised.py``.

Launches ``python -m tpugs_torch.apps.train`` and, on a non-zero exit,
relaunches it with ``--resume <newest ckpts/full_*.npz>`` (which restores
the step, the scene, the optimizers and the pose and appearance modules),
up to ``--retries`` times. Progress lost to a crash is bounded by
``--save-every``.

    python -m tpugs_torch.apps.train_supervised --retries 10 -- \
        --data-dir DATA --result-dir OUT --max-steps 30000 --chunked \
        --save-every 1000
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import time


def latest_full_ckpt(result_dir: str):
    """Newest resumable checkpoint by step number, or None."""
    paths = glob.glob(os.path.join(result_dir, "ckpts", "full_*.npz"))
    best, best_step = None, -1
    for p in paths:
        m = re.search(r"full_(\d+)\.npz$", p)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--retries", type=int, default=10)
    ap.add_argument("--backoff-s", type=float, default=30.0,
                    help="seconds to wait before a resume")
    ap.add_argument("--budget-s", type=float, default=0.0,
                    help="wall-clock budget: when exceeded, terminate "
                         "the run cleanly (progress persists in the "
                         "latest full_*.npz). 0 = unlimited")
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="-- then tpugs_torch.apps.train arguments")
    args = ap.parse_args(argv)
    train_args = [a for a in args.train_args if a != "--"]

    # result_dir is where checkpoints land; find it in the passed args
    result_dir = None
    for i, a in enumerate(train_args):
        if a == "--result-dir" and i + 1 < len(train_args):
            result_dir = train_args[i + 1]
        elif a.startswith("--result-dir="):
            result_dir = a.split("=", 1)[1]
    if result_dir is None:
        ap.error("--result-dir must be present in the train arguments")

    deadline = time.time() + args.budget_s if args.budget_s > 0 else None
    attempt = 0
    while True:
        cmd = [sys.executable, "-m", "tpugs_torch.apps.train", *train_args]
        ckpt = latest_full_ckpt(result_dir)
        if ckpt:
            cmd += ["--resume", ckpt]
        print(f"[supervisor] attempt {attempt}: {' '.join(cmd)}",
              flush=True)
        proc = subprocess.Popen(cmd)
        try:
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                raise subprocess.TimeoutExpired(cmd, 0)
            rc = proc.wait(timeout=remaining)
        except subprocess.TimeoutExpired:
            print("[supervisor] budget exhausted; terminating child "
                  f"(pid {proc.pid}) — latest checkpoint: "
                  f"{latest_full_ckpt(result_dir)}", flush=True)
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            return 0
        if rc == 0:
            print("[supervisor] training completed", flush=True)
            return 0
        attempt += 1
        if attempt > args.retries:
            print(f"[supervisor] giving up after {args.retries} retries "
                  f"(last rc={rc})", flush=True)
            return rc
        if deadline is not None and time.time() >= deadline:
            print("[supervisor] budget exhausted after crash; stopping",
                  flush=True)
            return rc
        print(f"[supervisor] rc={rc}; resuming from "
              f"{latest_full_ckpt(result_dir) or 'scratch'} in "
              f"{args.backoff_s:.0f}s", flush=True)
        time.sleep(args.backoff_s)


if __name__ == "__main__":
    sys.exit(main())
