"""``benchmark/spans.py`` on a hand-written trace, and the span and counter
readers in a tiny traced run on the CPU:

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest

from benchmark import spans, trace
from benchmark.tests.test_bench_harness import run_tiny


def _x(cat, name, ts, dur, tid=7, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _kernel(name, ts, dur, corr):
    return {**_x("kernel", name, ts, dur, corr=corr), "pid": 0, "tid": 3}


# The window [0, 1000) us; on thread 7 one view with the pack [30, 100) and
# the plan [150, 350), which waits in a sync [260, 300) after its first
# launch; thread 9 launches once, outside every span.
HAND = [
    _x("user_annotation", trace.WINDOW, 0.0, 1000.0),
    _x("user_annotation", "tpugs.lift.call", 10.0, 980.0),
    _x("user_annotation", "tpugs.lift.view", 20.0, 480.0),
    _x("user_annotation", "tpugs.lift.pack", 30.0, 70.0),
    _x("user_annotation", "tpugs.lift.plan", 150.0, 200.0),
    _x("user_annotation", "tpugs.sync.x", 260.0, 40.0),
    _x("cuda_runtime", "cudaLaunchKernel", 40.0, 5.0, corr=1),
    _kernel("pack_gather", 60.0, 100.0, 1),  # [60, 160): launched in the pack
    _kernel("orphan", 170.0, 30.0, 2),  # [170, 200): no launch event
    _x("cuda_driver", "cuLaunchKernelEx", 160.0, 5.0, corr=3),
    _kernel("plan_sort", 205.0, 45.0, 3),  # [205, 250): launched in the plan
    _x("cuda_runtime", "cudaLaunchKernel", 320.0, 5.0, corr=5),
    _kernel("plan_next", 330.0, 10.0, 5),  # [330, 340): launched after the sync
    _x("cuda_runtime", "cudaLaunchKernel", 45.0, 5.0, tid=9, corr=4),
    _kernel("other_thread", 350.0, 10.0, 4),  # [350, 360): thread 9 has no span
]


def test_a_kernel_is_attributed_by_its_launchs_correlation():
    got = {e["name"]: spans._names(st) for e, st in spans.attributed(HAND)}
    assert got["pack_gather"] == ("tpugs.lift.call", "tpugs.lift.view", "tpugs.lift.pack")
    assert got["plan_sort"] == got["plan_next"] == (
        "tpugs.lift.call", "tpugs.lift.view", "tpugs.lift.plan")
    assert got["other_thread"] == ()
    assert spans.device_ms_per_view(HAND, "tpugs.lift.pack") == pytest.approx(0.1)
    assert spans.device_ms_per_view(HAND, "tpugs.lift.plan") == pytest.approx(0.055)


def test_a_kernel_with_no_launch_event_is_unattributed():
    got = {e["name"]: st for e, st in spans.attributed(HAND)}
    assert got["orphan"] is None
    r = spans.report(HAND)
    assert r["unattributed_ms"] == pytest.approx(0.04)
    assert r["attributed_share"] == pytest.approx(155 / 195) and r["early_ops"] == 0


def test_a_gap_the_host_spends_in_a_sync_span_is_sync_idle():
    # gaps on the device's clock, each held by the spans on the host's: [0,
    # 60) by the pack (its launch ends it), [160, 170) by none (the orphan
    # has no launch), [200, 205) by the plan, [250, 330) by the sync (the
    # host passed through it between the launches at 160 and 320), [340,
    # 350) by none (thread 9), the tail [360, 1000) by none (no launch)
    held = [(a, b, spans._names(st)[-1:]) for a, b, st in spans.idle_gaps(HAND)]
    assert held == [(0.0, 60.0, ("tpugs.lift.pack",)), (160.0, 170.0, ()),
                    (200.0, 205.0, ("tpugs.lift.plan",)), (250.0, 330.0, ("tpugs.sync.x",)),
                    (340.0, 350.0, ()), (360.0, 1000.0, ())]
    assert spans.sync_idle_ms_per_view(HAND) == pytest.approx(0.08)
    idle = spans.report(HAND)["idle_ms_in_call_by_span"]
    assert idle == pytest.approx({"tpugs.lift.pack": 0.06, "tpugs.lift.plan": 0.005,
                                  "tpugs.sync.x": 0.08})


def test_without_view_spans_or_device_work_the_readers_read_none():
    bare = [e for e in HAND if not e["name"].startswith("tpugs.")]
    assert spans.device_ms_per_view(bare, "tpugs.lift.pack") is None
    assert spans.sync_idle_ms_per_view(bare) is None
    host_only = [e for e in HAND if e.get("cat") != "kernel"]
    assert spans.device_ms_per_view(host_only, "tpugs.lift.pack") is None
    assert spans.sync_idle_ms_per_view(host_only) is None


def test_tiny_traced_run_reports_the_walked_slot_share():
    m = run_tiny("lift.lseg.garden", trace=1)["metrics"]
    assert 0 < m["walked_slot_share.lift"]["value"] <= 100
    assert m["encode_enqueue_ms.lift"]["value"] > 0  # timed with no profiler recording
    # the CPU has no device: no device figure is reported
    assert not {"project_ms.lift", "sync_idle_ms.lift"} & set(m)
