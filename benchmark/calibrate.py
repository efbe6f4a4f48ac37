#!/usr/bin/env python3
"""The control's readings, the upper end that each compared number's limit
is set below, at a cell's own size on the card: per seed, the reference
one precision below the configuration's (encoder products and rows fp8,
sums and field bf16) put in the program's place and held to the float32
reference by the run's own numbers. The lower readings are the program's,
which every run of the cell prints (``check`` on its last line).

    python3 benchmark/calibrate.py --workload lift.lseg.garden --seeds 201,202,203

Each reading is printed as ``CAL control <cell> seed=<n> <name>=<value> ...``
and a summary line gives each number's smallest reading. The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference.precision import exact_float32  # noqa: E402


def control_reading(spec: dict, seed: int, dev) -> dict:
    path = harness.path_class(spec["workload"]["path"])(spec["workload"], spec["config"], seed, dev)
    with exact_float32():
        out = path.control_reading()
    del path
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None, spec=None, dev=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    spec = spec or harness.cell(args.workload)
    dev = dev or torch.device("cuda")
    readings = []
    for s in [int(x) for x in args.seeds.split(",") if x]:
        r = control_reading(spec, s, dev)
        readings.append(r)
        print(f"CAL control {args.workload} seed={s} "
              + " ".join(f"{k}={v!r}" for k, v in r.items()), flush=True)
    least = {k: min(r[k] for r in readings) for k in readings[0]}
    print(f"CAL summary {args.workload} "
          + " ".join(f"{k}: control_min={v!r}" for k, v in least.items()), flush=True)
    return least


if __name__ == "__main__":
    main()
