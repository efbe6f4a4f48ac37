"""Tracing, stage timing and roofline accounting for the port.
Counterpart: ``tpugs/utils/profiling.py``.

* ``trace`` — a ``torch.profiler`` capture (CPU, and CUDA where the card
  is) written as a Chrome trace under ``logdir``, with the body's counts
  of every ``register_counters`` object beside it. Unlike the
  reference's, a profiler that cannot start raises: a run that asked for
  a trace gets one or fails.
* ``annotation`` — a named host span in the trace
  (``torch.profiler.record_function``) while a profiler records, else a
  shared no-op context: the lift's spans cost one check each untraced.
  A ``timed`` span's host seconds go to ``HOST_TIMES`` while no profiler
  records (the profiler's own cost per operation would swell them).
* ``StageTimer`` — host-side stage table for the roofline report. On a
  CUDA device it synchronises at each stage's entry and exit, so a stage's
  seconds are the device's work and not only the host's enqueue.
* ``kernel_stats`` / ``roofline_report`` and the workload models
  (``render_model``, ``adjoint_model``, ``reduce_model``,
  ``lseg_encoder_model``, ``sol_estimate``): the reference's analytic
  roofline, arithmetic unchanged. The models count 16x16 tiles whatever
  tile the lift runs at; ``chip_smoke.py``'s kernel bounds count the walked
  and weighted pairs of each run instead.
* ``device_memory_stats`` — live, peak and total bytes of the card.
* ``device_idle_share`` and ``kernel_times`` read a Chrome trace: the
  share of a window in which no kernel, copy or memset ran, and device
  time by kernel name.

Peaks default to the H100 SXM's published dense rates, and
``sol_estimate`` prices the reduce's row gathers at the card's HBM rate.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import torch

from tpugs_torch.core.device import DeviceLike, resolve_device

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit.
PEAKS_H100 = {
    "tflops_bf16": 989.0,
    "tflops_f32": 67.0,
    "hbm_gbps": 3350.0,
}

# Chrome-trace categories of work on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_FILE = "trace.json"
COUNTERS_FILE = "counters.json"
_NO_SPAN = contextlib.nullcontext()
_COUNTERS: Dict[str, object] = {}


def register_counters(name: str, counts) -> None:
    """Has ``trace`` write ``counts``' change over its body to
    ``counters.json`` under ``name``; ``counts.snapshot()`` returns a dict
    of numbers."""
    _COUNTERS[name] = counts


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """``with trace(logdir) as path:`` profiles the body and writes a
    Chrome trace to ``path`` (``logdir/trace.json``) on exit, and the
    change over the body of each registered counter to
    ``logdir/counters.json`` as ``{name: snapshot}`` (``register_counters``;
    ``raster/kernels.py`` registers ``"work"`` and ``"launches"``).
    ``None`` or ``""`` disables it (``path`` is None). CUDA activity is
    recorded where ``torch.cuda.is_available()``."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = {k: c.snapshot() for k, c in _COUNTERS.items()}
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    after = {k: _COUNTERS[k].snapshot() for k in before}
    with open(os.path.join(logdir, COUNTERS_FILE), "w") as f:
        json.dump({k: {c: v - before[k][c] for c, v in after[k].items()} for k in after}, f,
                  indent=1)
    print(f"# trace written to {path}", flush=True)


class HostTimes:
    """Host seconds of each ``timed`` span (``annotation``) that ran while
    no profiler recorded, the last ``KEEP`` of each name."""

    KEEP = 4096

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.seconds: Dict[str, List[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        times = self.seconds.setdefault(name, [])
        times.append(seconds)
        if len(times) > self.KEEP:
            del times[0]

    def median_ms(self, name: str) -> Optional[float]:
        times = self.seconds.get(name)
        return 1e3 * statistics.median(times) if times else None


HOST_TIMES = HostTimes()


class _Timed:
    __slots__ = ("name", "t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        HOST_TIMES.add(self.name, time.perf_counter() - self.t0)


def annotation(name: str, timed: bool = False):
    """A named span in the trace: ``torch.profiler.record_function(name)``
    while a profiler records, so that it lands on the device trace's
    clock; otherwise one shared no-op context (a record_function costs
    some 20 us even with no profiler, the check well under 1 us). With
    ``timed`` and no profiler, the span's host seconds go to
    ``HOST_TIMES`` instead."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _Timed(name) if timed else _NO_SPAN


def kernel_stats(
    name: str,
    seconds: float,
    flops: float = 0.0,
    hbm_bytes: float = 0.0,
    dtype: str = "bf16",
    peaks: Dict[str, float] = PEAKS_H100,
) -> dict:
    """Roofline numbers for one stage.

    ``bound`` compares the stage's arithmetic intensity (FLOPs/byte)
    against the ridge point peak_flops/peak_bw; ``pct_peak`` is
    achieved/peak on the binding resource."""
    peak_tf = peaks["tflops_bf16" if dtype == "bf16" else "tflops_f32"]
    peak_bw = peaks["hbm_gbps"]
    tflops = flops / seconds / 1e12 if seconds > 0 else 0.0
    gbps = hbm_bytes / seconds / 1e9 if seconds > 0 else 0.0
    intensity = flops / hbm_bytes if hbm_bytes > 0 else float("inf")
    ridge = peak_tf * 1e12 / (peak_bw * 1e9)  # FLOPs/byte
    bound = "compute" if intensity >= ridge else "memory"
    pct = (
        100.0 * tflops / peak_tf if bound == "compute"
        else 100.0 * gbps / peak_bw
    )
    return {
        "name": name,
        "seconds": seconds,
        "tflops": tflops,
        "gbps": gbps,
        "intensity": intensity,
        "bound": bound,
        "pct_peak": pct,
    }


def roofline_report(stages: List[dict]) -> str:
    """Fixed-width table of ``kernel_stats`` rows."""
    head = (
        f"{'stage':<28}{'ms':>9}{'TFLOP/s':>9}{'GB/s':>8}"
        f"{'FLOP/B':>8}{'bound':>9}{'%peak':>7}"
    )
    lines = [head, "-" * len(head)]
    for s in stages:
        inten = (
            f"{s['intensity']:.1f}" if s["intensity"] != float("inf")
            else "inf"
        )
        lines.append(
            f"{s['name']:<28}{s['seconds'] * 1e3:>9.2f}"
            f"{s['tflops']:>9.2f}{s['gbps']:>8.1f}{inten:>8}"
            f"{s['bound']:>9}{s['pct_peak']:>6.1f}%"
        )
    return "\n".join(lines)


# ----------------------------------------------------------- workload models
def render_model(n_isect: int, n_pix: int, d_chan: int = 3) -> dict:
    """FLOPs/bytes of the tiled forward composite: per intersection x
    pixel-in-tile, a conic eval (~10 flop) + blend (~2*d). Bytes: one read
    of each packed intersection row (~64 B) + tile image traffic."""
    tile_pix = 256  # 16x16, the reference's tile
    flops = float(n_isect) * tile_pix * (10 + 2 * d_chan)
    hbm = float(n_isect) * 64 + float(n_pix) * 4 * (d_chan + 1)
    return {"flops": flops, "hbm_bytes": hbm}


def adjoint_model(n_isect: int, d_chan: int) -> dict:
    """Scatter-free adjoint: per intersection, a d-dim feature MAC against
    the tile's pixel block + a weight row write (d+1 bf16 values)."""
    tile_pix = 256
    flops = float(n_isect) * tile_pix * (2 * d_chan + 8)
    hbm = float(n_isect) * (2 * (d_chan + 1) + 64)
    return {"flops": flops, "hbm_bytes": hbm}


def reduce_model(n_slots: int, d_chan: int) -> dict:
    """Slot-table gather/sum: memory bound, every slot row read once."""
    flops = float(n_slots) * d_chan
    hbm = float(n_slots) * 2 * (d_chan + 1)
    return {"flops": flops, "hbm_bytes": hbm}


def lseg_encoder_model(
    crop: int = 480,
    patch: int = 16,
    width: int = 1024,
    layers: int = 24,
    head_features: int = 256,
    out_dim: int = 512,
    bytes_per_param: float = 2.0,
) -> dict:
    """FLOPs/bytes of one LSeg ViT-L/16 forward at the 480x480 crop.

    ViT: per layer ~24*T*w^2 matmul FLOPs + 4*T^2*w attention FLOPs (T
    tokens). Head: 4 fusion levels of 3x3 conv pairs at doubling
    resolutions + the out_dim projection at half-crop resolution. Bytes:
    one pass over the parameters + crop image traffic, activations
    assumed resident."""
    t = (crop // patch) ** 2 + 1
    vit_flops = layers * (24.0 * t * width**2 + 4.0 * t * t * width)
    g = crop // patch
    head_flops = 0.0
    for k in range(4):
        hw = float(g * 2**k) ** 2
        head_flops += 4 * (2 * hw * 9 * head_features * head_features)
    half = float(crop // 2) ** 2
    head_flops += 2 * half * head_features * out_dim
    n_params = layers * 12 * width**2 + 4 * 9 * head_features**2 * 4
    hbm = n_params * bytes_per_param + crop * crop * 4.0 * (3 + out_dim)
    return {"flops": vit_flops + head_flops, "hbm_bytes": hbm}


def sol_estimate(
    n_isect: int,
    n_pix: int,
    d_feat: int,
    slot_rows: Optional[int] = None,
    gather_gbps: Optional[float] = None,
    peaks: Dict[str, float] = PEAKS_H100,
    encode_model: Optional[dict] = None,
) -> dict:
    """Per-view speed of light of the fused back-projection.

    For each stage, SOL seconds = max(flops / bf16 peak, bytes / the
    binding bandwidth) from the models above; the reduce's row gathers run
    at ``gather_gbps`` (default: the card's HBM rate). Returns per-stage
    seconds and their ``total``."""
    peak_f = peaks["tflops_bf16"] * 1e12

    def sol(m, bw=None):
        b = (bw or peaks["hbm_gbps"]) * 1e9
        return max(m["flops"] / peak_f, m["hbm_bytes"] / b)

    d = d_feat + 1  # the ones-channel denominator rides along
    stages = {
        "render": sol(render_model(n_isect, n_pix, 3)),
        # the default prices the linear map: one n_pix x 3 @ 3 x d_feat
        # product + image traffic; pass lseg_encoder_model() for a ViT
        "encode": sol(encode_model or {
            "flops": 2.0 * n_pix * 3 * d_feat,
            "hbm_bytes": n_pix * 2.0 * (3 + d_feat),
        }),
        "adjoint": sol(adjoint_model(n_isect, d)),
        # plan: expand + one key sort + scatter over the intersection
        # list (~6 HBM passes of key + payload)
        "plan": sol({"flops": 0.0, "hbm_bytes": n_isect * 48.0}),
        "reduce": sol(
            reduce_model(slot_rows or n_isect, d), bw=gather_gbps
        ),
    }
    stages["total"] = sum(stages.values())
    return stages


@dataclass
class StageTimer:
    """Accumulates (stage, seconds [, flops, bytes]) rows; ``report()``
    prints the roofline table at ``peaks``. On a CUDA ``device`` each
    stage synchronises it at entry and exit."""

    dtype: str = "bf16"
    rows: List[dict] = field(default_factory=list)
    device: DeviceLike = "cuda"
    peaks: Dict[str, float] = field(default_factory=lambda: dict(PEAKS_H100))

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str, flops: float = 0.0, hbm_bytes: float = 0.0):
        with annotation(name):
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            dt = time.perf_counter() - t0
        self.add(name, dt, flops, hbm_bytes)

    def add(self, name, seconds, flops=0.0, hbm_bytes=0.0):
        self.rows.append(
            kernel_stats(name, seconds, flops, hbm_bytes, dtype=self.dtype,
                         peaks=self.peaks)
        )

    def report(self) -> str:
        return roofline_report(self.rows)

    def totals(self) -> Dict[str, float]:
        """Seconds summed by stage name, in first-seen order."""
        out: Dict[str, float] = {}
        for r in self.rows:
            out[r["name"]] = out.get(r["name"], 0.0) + r["seconds"]
        return out


def device_memory_stats(device: DeviceLike = "cuda") -> Optional[dict]:
    """Live and peak allocator bytes and the card's total on a CUDA
    ``device``; None on the CPU, which keeps no such statistics."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    return {
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


# ------------------------------------------------------------ trace readers
TraceLike = Union[str, dict]


def _events(trace_json: TraceLike) -> List[dict]:
    if isinstance(trace_json, str):
        with open(trace_json) as f:
            trace_json = json.load(f)
    events = trace_json["traceEvents"] if isinstance(trace_json, dict) else trace_json
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _span(e: dict) -> Tuple[float, float]:
    t0 = float(e["ts"])
    return t0, t0 + float(e["dur"])


def device_idle_share(trace_json: TraceLike, window: Optional[Tuple[float, float]] = None) -> dict:
    """The share of ``window`` (start, end) in microseconds of the trace's
    clock in which the device ran no kernel, copy or memset: one minus the
    union of those intervals over the window's length. The default window
    runs from the start of the first host annotation to the end of the
    last. Returns ``idle_share``, ``busy_ms``, ``window_ms`` and
    ``events`` (device intervals that overlap the window)."""
    events = _events(trace_json)
    if window is None:
        spans = [_span(e) for e in events if e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError("the trace holds no host annotation to take the window from")
        window = (min(s[0] for s in spans), max(s[1] for s in spans))
    w0, w1 = window
    if w1 <= w0:
        raise ValueError(f"empty window {window}")
    device = sorted(
        (max(a, w0), min(b, w1))
        for a, b in (_span(e) for e in events if e.get("cat") in DEVICE_CATEGORIES)
        if b > w0 and a < w1
    )
    busy, end = 0.0, w0
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"idle_share": 1.0 - busy / (w1 - w0), "busy_ms": busy / 1e3,
            "window_ms": (w1 - w0) / 1e3, "events": len(device)}


def kernel_times(trace_json: TraceLike, pattern: str) -> Tuple[int, float]:
    """(launches, total ms) of the trace's device kernels whose name matches
    the regular expression ``pattern``."""
    rx = re.compile(pattern)
    spans = [_span(e) for e in _events(trace_json)
             if e.get("cat") == "kernel" and rx.search(e.get("name", ""))]
    return len(spans), sum(b - a for a, b in spans) / 1e3
