"""A traced sub-window and what the benchmark reads from its Chrome trace.

``idle_share`` and ``kernel_ms`` are frozen copies of the program's
``utils/profiling.py::device_idle_share`` and ``kernel_times``
arithmetic: the union of device intervals (kernels, copies, memsets)
over the window, and device time by kernel name. ``breakdown`` lists the
device operations that took most time and the longest idle gaps, each
named by what the host was doing when it began.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "benchmark.traced_window"
TOP = 10


def record(fn: Callable[[], object]) -> Tuple[List[dict], float]:
    """``fn()`` under ``torch.profiler`` inside one annotation, the device
    synchronised before it closes: (the trace's complete events, the
    window's seconds by the host clock). The trace file lives in a
    temporary directory (under ``TMPDIR``) and is deleted once read."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e], wall


def _span(e: dict) -> Tuple[float, float]:
    t0 = float(e["ts"])
    return t0, t0 + float(e["dur"])


def window(events: List[dict]) -> Tuple[float, float]:
    spans = [_span(e) for e in events if e.get("name") == WINDOW]
    if not spans:
        raise ValueError("the trace holds no window annotation")
    return min(s[0] for s in spans), max(s[1] for s in spans)


def _device(events: List[dict], w0: float, w1: float) -> List[Tuple[float, float]]:
    return sorted((max(a, w0), min(b, w1))
                  for a, b in (_span(e) for e in events if e.get("cat") in DEVICE_CATEGORIES)
                  if b > w0 and a < w1)


def idle_share(events: List[dict]) -> Dict[str, float]:
    """``busy_s``, ``window_s`` and ``idle_share`` of the window: one minus
    the union of device intervals over its length."""
    w0, w1 = window(events)
    busy, end = 0.0, w0
    for a, b in _device(events, w0, w1):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "idle_share": 1.0 - busy / (w1 - w0), "device_events": len(_device(events, w0, w1))}


def kernel_ms(events: List[dict], pattern: str) -> Tuple[int, float]:
    """(launches, total ms) of the window's kernels whose name matches
    ``pattern``."""
    rx = re.compile(pattern)
    spans = [_span(e) for e in events
             if e.get("cat") == "kernel" and rx.search(e.get("name", ""))]
    return len(spans), sum(b - a for a, b in spans) / 1e3


def breakdown(events: List[dict]) -> dict:
    """The ``TOP`` device operations by total seconds, and the ``TOP``
    longest idle gaps, each named by the innermost host operation under
    way when it began."""
    w0, w1 = window(events)
    totals: Dict[str, float] = {}
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            a, b = _span(e)
            if b > w0 and a < w1:
                totals[e.get("name", "?")] = totals.get(e.get("name", "?"), 0.0) + (b - a) / 1e6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    gaps, end = [], w0
    for a, b in _device(events, w0, w1):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    host = [(e, *_span(e)) for e in events
            if e.get("cat") in ("cpu_op", "user_annotation", "python_function")
            and e.get("name") != WINDOW]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        under = [(s, e.get("name", "?")) for e, s, t in host if s <= a < t]
        named.append([max(under)[1] if under else "host", (b - a) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
