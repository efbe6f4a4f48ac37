"""Where a traced window's device time and idle time fall among the
program's spans: ``tpugs.*`` host spans, which the program opens through
``tpugs_torch/utils/profiling.py::annotation`` while a profiler records.

A kernel, copy or memset belongs to the innermost ``tpugs.*`` span that
was open on the launching thread when its launch began: the
``cuda_runtime`` or ``cuda_driver`` event with the same
``args.correlation``. One with no launch event, or launched outside every
span, belongs to none. An idle gap of the device (between the intervals
of their union, as ``trace.idle_share`` counts them) belongs to the spans
that held the host back, read on the host's clock alone: those open when
the host launched the operation that ends the gap, or, where the host
passed through a ``tpugs.sync.*`` span between launching the operation
before the gap and that launch, those open as that sync began (the host
waited there while the device drained). Figures per view divide by the
number of ``tpugs.lift.view`` spans; with none (a program without spans),
or with no device operation (a run on the CPU), a device figure reads
None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark import trace

PREFIX = "tpugs."
VIEW = "tpugs.lift.view"
CALL = "tpugs.lift.call"
SYNC = "tpugs.sync."
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# host reads that wait for the device
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "aten::_local_scalar_dense", "aten::nonzero")

Span = Tuple[float, float, str]  # start, end (microseconds), name
Stack = Tuple[Span, ...]  # the open spans, outermost first


def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


def _spans(events: List[dict]) -> Dict[tuple, List[Span]]:
    """The ``tpugs.*`` spans of each thread, sorted outer before inner."""
    out = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX):
            t0, t1 = trace._span(e)
            out[_thread(e)].append((t0, t1, e["name"]))
    for s in out.values():
        s.sort(key=lambda x: (x[0], -x[1]))
    return out


def _stacks(spans: List[Span], times: List[float]) -> List[Stack]:
    """The spans (properly nested, as one thread's are) open at each of
    ``times``: those with t0 <= t < t1."""
    out: List[Stack] = [()] * len(times)
    stack: List[Span] = []
    i = 0
    for q in sorted(range(len(times)), key=lambda k: times[k]):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[q] = tuple(stack)
    return out


def _names(st: Optional[Stack]) -> Tuple[str, ...]:
    return tuple(s[2] for s in st or ())


def _correlation(e: Optional[dict]):
    return None if e is None else (e.get("args") or {}).get("correlation")


def _launches(events: List[dict]) -> Dict[object, dict]:
    return {_correlation(e): e for e in events
            if e.get("cat") in LAUNCH_CATEGORIES and _correlation(e) is not None}


def _device(events: List[dict]) -> List[dict]:
    w0, w1 = trace.window(events)
    return [e for e in events if e.get("cat") in trace.DEVICE_CATEGORIES
            and trace._span(e)[1] > w0 and trace._span(e)[0] < w1]


def _stacks_by_thread(spans: Dict[tuple, List[Span]], queries) -> List[Stack]:
    """The open spans for each query (thread, host time), in order."""
    out: List[Stack] = [()] * len(queries)
    by_thread = defaultdict(list)
    for k, (th, t) in enumerate(queries):
        by_thread[th].append((k, t))
    for th, q in by_thread.items():
        for (k, _), st in zip(q, _stacks(spans.get(th, []), [t for _, t in q])):
            out[k] = st
    return out


def attributed(events: List[dict]) -> List[Tuple[dict, Optional[Stack]]]:
    """Each device operation of the window with the ``tpugs.*`` spans open
    at its launch (None without a launch event)."""
    launch = _launches(events)
    ops = _device(events)
    found = [(k, launch.get(_correlation(e))) for k, e in enumerate(ops)]
    found = [(k, ln) for k, ln in found if ln is not None]
    stacks = _stacks_by_thread(_spans(events), [(_thread(ln), float(ln["ts"])) for _, ln in found])
    out: List[Tuple[dict, Optional[Stack]]] = [(e, None) for e in ops]
    for (k, _), st in zip(found, stacks):
        out[k] = (ops[k], st)
    return out


def views(events: List[dict]) -> int:
    return sum(1 for e in events if e.get("cat") == "user_annotation" and e.get("name") == VIEW)


def device_ms_per_view(events: List[dict], name: str) -> Optional[float]:
    """Device milliseconds a view of the operations launched under span
    ``name``, its child spans included."""
    n = views(events)
    ops = attributed(events)
    if not n or not ops:
        return None
    us = sum(trace._span(e)[1] - trace._span(e)[0] for e, st in ops if name in _names(st))
    return us / 1e3 / n


def idle_gaps(events: List[dict]) -> List[Tuple[float, float, Stack]]:
    """The window's device idle gaps (start, end, in microseconds on the
    device's clock), each with the spans that held the host back (the
    module's rule, on the host's clock): none where no launch event ends
    the gap, as at the window's tail."""
    w0, w1 = trace.window(events)
    ops = sorted(((max(trace._span(e)[0], w0), min(trace._span(e)[1], w1), e)
                  for e in _device(events)), key=lambda x: x[:2])
    gaps, end, prev = [], w0, None
    for a, b, e in ops:
        if a > end:
            gaps.append((end, a, prev, e))
        if b > end:
            end, prev = b, e
    if w1 > end:
        gaps.append((end, w1, prev, None))
    launch, spans = _launches(events), _spans(events)
    queries, held = [], []
    for a, b, p, n in gaps:
        ln, lp = launch.get(_correlation(n)), launch.get(_correlation(p))
        if ln is None:
            held.append(None)
            continue
        th, t = _thread(ln), float(ln["ts"])
        if lp is not None and _thread(lp) == th:
            lo = float(lp["ts"])
            syncs = [s0 for s0, s1, name in spans.get(th, [])
                     if name.startswith(SYNC) and s0 < t and s1 > lo]
            if syncs:
                t = max(max(syncs), lo)
        held.append(len(queries))
        queries.append((th, t))
    stacks = _stacks_by_thread(spans, queries)
    return [(a, b, () if h is None else stacks[h]) for (a, b, _, _), h in zip(gaps, held)]


def sync_idle_ms_per_view(events: List[dict]) -> Optional[float]:
    """Device idle milliseconds a view in gaps held by a ``tpugs.sync.*``
    span (``idle_gaps``): the device drained while the host waited for a
    read."""
    n = views(events)
    if not n or not _device(events):
        return None
    return sum(b - a for a, b, st in idle_gaps(events)
               if any(s.startswith(SYNC) for s in _names(st))) / 1e3 / n


def report(events: List[dict]) -> dict:
    """What the trace says of the spans, in milliseconds: device time by
    innermost span and what none holds; idle time of the gaps that the
    call's spans hold (``idle_gaps``), by innermost span; operations whose
    start on the device's clock precedes their span's on the host's (a
    check of the two clocks, which the attribution does not rely on); and each blocking host read (``BLOCKING``, and every
    device-to-host copy's launch) outside every ``tpugs.sync.*`` span,
    by name, inside the call."""
    ops = attributed(events)
    by_span: Dict[str, float] = defaultdict(float)
    none, early, dtoh = 0.0, 0, set()
    for e, st in ops:
        a, b = trace._span(e)
        if st:
            by_span[st[-1][2]] += (b - a) / 1e3
            early += int(a < st[-1][0])
        else:
            none += (b - a) / 1e3
        if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""):
            dtoh.add((e.get("args") or {}).get("correlation"))
    calls = [trace._span(e) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == CALL]
    idle: Dict[str, float] = defaultdict(float)
    for a, b, st in idle_gaps(events):
        if CALL in _names(st):
            idle[st[-1][2]] += (b - a) / 1e3
    syncs = [trace._span(e) for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SYNC)]
    outside: Dict[str, int] = defaultdict(int)
    for e in events:
        blocking = e.get("name") in BLOCKING or (
            e.get("cat") in LAUNCH_CATEGORIES
            and (e.get("args") or {}).get("correlation") in dtoh)
        if not blocking:
            continue
        a, b = trace._span(e)
        if any(c0 <= a < c1 for c0, c1 in calls) and not any(
                s0 <= a and b <= s1 for s0, s1 in syncs):
            outside[e["name"]] += 1
    total = sum(by_span.values()) + none
    return {"views": views(events), "device_ms": total, "unattributed_ms": none,
            "attributed_share": sum(by_span.values()) / total if total else None,
            "early_ops": early, "device_ms_by_span": dict(by_span),
            "idle_ms_in_call_by_span": dict(idle), "blocking_outside_sync": dict(outside)}
