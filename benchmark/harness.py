"""What every cell shares: finding a cell's files by name, the stage
events, the per-layer metric readers, the check's limits, the imports a
run may not hold, and the result line."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpugs")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry, its workload file
    (``workloads/<name>.json``: path and traffic) and its configuration
    (``configs/<config>.json``)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = load_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    return {"entry": entry, "workload": work, "config": config, "bench": bench}


def path_class(path: str):
    return load_module(BENCH_DIR / "paths" / f"{path}.py", f"bench_path_{path}").PATH


def metrics_for(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports: those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def read_per_layer(metric: dict, ctx: dict) -> Optional[float]:
    """The reader ``metrics/<name>.py`` of a per-layer metric on the traced
    run's context; None when it finds nothing to read."""
    reader = load_module(BENCH_DIR / "metrics" / f"{metric['name']}.py",
                         "bench_metric_" + metric["name"].replace(".", "_"))
    return reader.read(ctx)


def forbidden_loaded() -> List[str]:
    """Modules in ``sys.modules`` whose top-level name is one of
    ``FORBIDDEN`` (compared whole: ``tpugs_torch`` is not ``tpugs``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class SetupClock:
    """Seconds of each part of a set-up, printed to standard error."""

    def __init__(self, what: str):
        import time

        self.what, self.time = what, time.perf_counter
        self.t = self.time()

    def lap(self, part: str) -> None:
        now = self.time()
        print(f"set-up {self.what}: {part} {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now


class Stages:
    """The program's ``on_stage`` callback: a CUDA event at the end of each
    stage (and at each job's start, "job"). ``totals_ms`` sums each stage's
    time from the event before it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: List[tuple] = []

    def mark(self, name: str) -> None:
        if not self.enabled:
            return
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def totals_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            if name != "job":
                out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def limits(workload: dict) -> Dict[str, float]:
    return workload["check"]["limits"]


def judged(numbers: Dict[str, float], lim: Dict[str, float]) -> Dict[str, dict]:
    """Each number compared beside its limit; a number that is not finite
    fails."""
    out = {}
    for k, v in numbers.items():
        ok = v == v and v <= lim[k]
        out[k] = {"value": v, "limit": lim[k], "ok": bool(ok)}
    return out


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The check's lines on standard error, last; the result line last on
    standard output, the compared numbers under its last key."""
    result["check"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


# ------------------------------------------------ per-layer readers' helpers

def stage_ms_per_unit(ctx: dict, path: str, names) -> Optional[float]:
    """The window's time in the program's stages ``names`` per view or step
    (its ``on_stage`` CUDA events), or None outside ``path``."""
    if ctx["path"] != path or not all(n in ctx["stage_ms"] for n in names):
        return None
    return sum(ctx["stage_ms"][n] for n in names) / ctx["units"]


def roofline_pct(ctx: dict, path: str, kernel: str) -> Optional[float]:
    """100 x the counted work's least time over the kernel's time in the
    traced job, or None where the path or the kernel is absent."""
    from benchmark import trace

    if ctx["path"] != path or kernel not in ctx["kernels"]:
        return None
    launches, ms = trace.kernel_ms(ctx["events"], ctx["kernels"][kernel])
    least = ctx["counts"]["kernels"].get(kernel)
    if not launches or ms <= 0 or least is None:
        return None
    return 100.0 * least / (ms / 1e3)


def mfu_pct(ctx: dict, path: str) -> Optional[float]:
    """100 x the least compute time of the traced job's counted work (the
    encoder's FLOPs at the bf16 peak, each kernel's operations at its
    precision's) over the job's wall time."""
    if ctx["path"] != path:
        return None
    return 100.0 * ctx["counts"]["least_compute_s"] / ctx["traced_wall_s"]


def idle_pct(ctx: dict, path: str) -> Optional[float]:
    if ctx["path"] != path or not ctx["idle"]["device_events"]:
        return None
    return 100.0 * ctx["idle"]["idle_share"]
