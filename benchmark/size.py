#!/usr/bin/env python3
"""Size each cell's Gaussian count to the card: from the count given
(default the cell's own), halving, the set-up plus one job of the cell;
prints each try's peak and time, then the reference's time for the first
view at the first count that fits.

    python3 benchmark/size.py --workload lift.lseg.garden --start 5800000 --seed 11
"""

from __future__ import annotations

import argparse
import copy
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference.precision import exact_float32  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--halvings", type=int, default=3)
    ap.add_argument("--start", type=int, default=0, help="the count to halve from (default the "
                    "cell's)")
    ap.add_argument("--limit-gb", type=float, default=76.0,
                    help="largest peak taken as fitting")
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    for name in args.workload:
        spec = copy.deepcopy(harness.cell(name))
        n0 = args.start or spec["workload"]["traffic"]["n_gaussians"]
        for h in range(args.halvings + 1):
            n = n0 >> h
            spec["workload"]["traffic"]["n_gaussians"] = n
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            path = None
            try:
                path = harness.path_class(spec["workload"]["path"])(
                    spec["workload"], spec["config"], args.seed, dev)
                path.setup()
                t1 = time.perf_counter()
                units = path.job()
                t2 = time.perf_counter()
                peak = torch.cuda.max_memory_allocated() / 1e9
                print(f"SIZE {name} n={n} set-up {t1 - t0:.2f} s, job of {units} units "
                      f"{t2 - t1:.3f} s, peak {peak:.2f} GB", flush=True)
                ok = peak <= args.limit_gb
            except torch.OutOfMemoryError as e:
                print(f"SIZE {name} n={n} out of memory: {str(e).splitlines()[0]}", flush=True)
                ok = False
            if path is not None:
                path.release()
            del path
            gc.collect()
            torch.cuda.empty_cache()
            if ok:
                path = harness.path_class(spec["workload"]["path"])(
                    spec["workload"], spec["config"], args.seed, dev)
                torch.cuda.reset_peak_memory_stats()
                with exact_float32():
                    t0 = time.perf_counter()
                    path.reference_time()
                    torch.cuda.synchronize()
                print(f"SIZE {name} n={n} reference of one view {time.perf_counter() - t0:.2f} s, "
                      f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
                del path
                gc.collect()
                torch.cuda.empty_cache()
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
