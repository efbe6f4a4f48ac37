#!/usr/bin/env python3
"""Run one cell of the benchmark of ``tpugs_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``tpugs_torch``. The cell's files
are found by its name in ``BENCHMARK.json``: ``benchmark/workloads/<cell>.json``
(its path and traffic), ``benchmark/configs/<config>.json`` (its sizes),
``benchmark/paths/<path>.py`` (the code that runs it). Set-up makes every input on
the card from the seed and warms the cell's shapes; the window then runs
whole jobs, closed loop, until ``--seconds`` have passed. With
``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` the program's stage events are recorded through the
window, a short job (the path's ``traced_job``) runs under
``torch.profiler``, and the result holds
the per-layer metrics (``benchmark/metrics/<name>.py``) and a breakdown.
After the window the program's state is freed and the plain reference
(``benchmark/reference``) checks what the window produced.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared beside its limit,
also printed as the last lines on standard error. Without CUDA cards
enough for the cell, or where a module named ``jax``, ``jaxlib``,
``flax`` or ``tpugs`` is loaded when the window has closed, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# fixed cache directories inside the checkout, so that only a checkout's
# first run builds (the program's nvcc library goes to build/tpugs_torch)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

from benchmark import harness  # noqa: E402

EXIT_NO_CHIP, EXIT_FORBIDDEN = 3, 4


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, spec=None, require_chip: bool = True) -> int:
    """``spec`` (a ``harness.cell`` dict) and ``require_chip=False`` let a
    test run a tiny cell on the CPU through the plain twins."""
    args = parse(argv)
    import torch

    clock = harness.SetupClock("run")

    spec = spec or harness.cell(args.workload)
    work, config, entry = spec["workload"], spec["config"], spec["entry"]
    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"the cell needs {entry['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return EXIT_NO_CHIP
        dev = torch.device("cuda")
        torch.cuda.init()
        clock.lap("imports and the card")
    else:
        dev = torch.device("cpu")
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    stages = harness.Stages(enabled=args.trace == 1 and cuda)
    path = harness.path_class(work["path"])(work, config, args.seed, dev, stages)
    path.setup()
    sync()
    setup_s = time.perf_counter() - T_START

    units, ends = 0, []
    t0 = time.perf_counter()
    while True:
        units += path.job()
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= args.seconds:
            break
    window_s = ends[-1] - t0
    jobs = sorted(b - a for a, b in zip([t0] + ends, ends))
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    ctx = None
    if args.trace:
        from benchmark import trace

        stage_ms = stages.totals_ms() if cuda else {}
        stages.enabled = False
        traced = {}

        def one_job():
            traced["views"] = path.traced_job()

        events, wall = trace.record(one_job)
        ctx = {"path": work["path"], "stage_ms": stage_ms, "units": units,
               "events": events, "traced_wall_s": wall,
               "idle": trace.idle_share(events), "kernels": path.KERNELS}
    found = harness.forbidden_loaded()
    if found:
        print(f"modules that the run may not load are loaded: {found}", file=sys.stderr)
        return EXIT_FORBIDDEN

    path.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from benchmark.reference.precision import exact_float32

    with exact_float32():
        numbers = path.check()
        if ctx is not None:
            ctx["counts"] = path.counts(traced["views"])
    checks = harness.judged(numbers, harness.limits(work))

    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": units, "failed": 0}
    values = {work["rate_metric"]: units / window_s, "peak_gb": peak / 1e9, "setup_s": setup_s}
    metrics = {}
    if ctx is None:
        for m in harness.metrics_for(spec["bench"], args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in harness.metrics_for(spec["bench"], args.workload, "per_layer"):
            v = harness.read_per_layer(m, ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                        "count": entry["chips"], "memory_peak_bytes": int(peak)}
    if ctx is not None:
        from benchmark import trace

        result["device"]["busy_s"] = ctx["idle"]["busy_s"]
        result["device"]["window_s"] = ctx["idle"]["window_s"]
        result["breakdown"] = trace.breakdown(ctx["events"])
    print(f"window {window_s:.3f} s, {units} {work['unit']}, set-up {setup_s:.3f} s; "
          f"{len(jobs)} jobs of {jobs[0]:.3f} to {jobs[-1]:.3f} s (median "
          f"{jobs[len(jobs) // 2]:.3f})", file=sys.stderr, flush=True)
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
