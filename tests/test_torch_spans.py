"""The lift's spans and work counters on the CPU (the twins), on a tiny
scene: 200 Gaussians, 3 views of 64 x 48, tile 16, the linear encoder at
D = 8.

* traced through ``utils/profiling.py::trace``, ``backproject_views``
  opens one ``tpugs.lift.view`` span a view, each stage span once inside
  it and in the pipeline's order, and the plan's four child spans inside
  the plan's; ``backproject_views_split`` opens every stage span once a
  view and ``tpugs.lift.encode`` once a group, under one call span;
* every host read of a tensor's value in the traced call lies inside a
  ``tpugs.sync.*`` span, or inside the render, adjoint and reduce spans,
  where the kernels' plain twins stand in for the card's kernels and read
  their own loop bounds;
* with no profiler, ``annotation`` never builds a ``record_function``,
  the ``on_stage`` sequence is ``STAGES`` per view, ``num`` and ``den``
  are bit-equal to the traced call's, and the encode span's host time is
  kept a view (``HOST_TIMES``), which a traced call leaves alone;
* ``WORK`` counts each view's ``T_padded``, ``n_isects`` and BLOCK x
  B1's blocks done (the lift counts them, the B1 wrapper alone nothing),
  and ``trace`` writes the body's counts to ``counters.json``.
"""

import json
import os

import pytest
import torch

from tpugs_torch.encoders.base import LinearRGBEncoder
from tpugs_torch.lift.batch import STAGES, backproject_views, backproject_views_split, run_view
from tpugs_torch.raster.kernels import WORK, render_tiles
from tpugs_torch.raster.plan import BLOCK
from tpugs_torch.utils.profiling import COUNTERS_FILE, HOST_TIMES, trace
from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

W, H, D, TILE, VIEWS = 64, 48, 8, 16, 3
VIEW_STAGES = ["tpugs.lift." + s for s in
               ("project", "sh", "plan", "pack", "render", "encode", "adjoint", "reduce",
                "accumulate")]
PLAN_CHILDREN = ["tpugs.plan." + s for s in ("cull", "sort", "slots", "csr")]
HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::item")
TWIN_STAGES = ["tpugs.lift." + s for s in ("render", "adjoint", "reduce")]
ENCODE = "tpugs.lift.encode"


@pytest.fixture(scope="module")
def inputs():
    scene = random_scene(200, seed=3, extent=0.8, scale_range=(0.02, 0.1), device="cpu")
    cams = orbit_cameras(VIEWS, W, H, radius=2.5, device="cpu")
    return scene, cams, LinearRGBEncoder(D, seed=1, device="cpu")


def _lift(inputs, split=False, **kw):
    scene, cams, enc = inputs
    if split:
        return backproject_views_split(scene, cams.viewmats, cams.Ks, W, H, enc, group_size=2,
                                       tile_size=TILE, device="cpu", **kw)
    return backproject_views(scene, cams.viewmats, cams.Ks, W, H, enc, tile_size=TILE,
                             device="cpu", **kw)


@pytest.fixture(scope="module")
def traced(inputs, tmp_path_factory):
    """{"views" / "split": (events, num, den, counters)} of traced calls."""
    out = {}
    HOST_TIMES.reset()
    for kind in ("views", "split"):
        logdir = str(tmp_path_factory.mktemp(kind))
        with trace(logdir) as path:
            num, den = _lift(inputs, split=kind == "split", cam_weights=torch.ones(VIEWS))
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        with open(os.path.join(logdir, COUNTERS_FILE)) as f:
            out[kind] = (events, num, den, json.load(f))
    assert HOST_TIMES.median_ms(ENCODE) is None  # nothing timed while traced
    return out


def _spans(events, prefix="tpugs."):
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda e: (e["ts"], -e["dur"]))


def _inside(e, outer):
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_each_view_holds_every_stage_span_once_in_order(traced):
    events = traced["views"][0]
    spans = _spans(events)
    (call,) = [s for s in spans if s["name"] == "tpugs.lift.call"]
    views = [s for s in spans if s["name"] == "tpugs.lift.view"]
    assert len(views) == VIEWS and all(_inside(v, call) for v in views)
    for v in views:
        stages = [s["name"] for s in spans if s["name"] in VIEW_STAGES and _inside(s, v)]
        assert stages == VIEW_STAGES
        (plan,) = [s for s in spans if s["name"] == "tpugs.lift.plan" and _inside(s, v)]
        assert [s["name"] for s in _spans(events, "tpugs.plan.") if _inside(s, plan)] == \
            PLAN_CHILDREN


def test_the_split_lift_encodes_once_a_group(traced):
    spans = _spans(traced["split"][0])
    count = {n: sum(s["name"] == n for s in spans) for n in VIEW_STAGES + ["tpugs.lift.view"]}
    groups = -(-VIEWS // 2)
    assert count == {**{n: VIEWS for n in VIEW_STAGES}, "tpugs.lift.encode": groups,
                     "tpugs.lift.view": 0}
    (call,) = [s for s in spans if s["name"] == "tpugs.lift.call"]
    assert all(_inside(s, call) for s in spans)


@pytest.mark.parametrize("kind", ["views", "split"])
def test_every_host_read_lies_in_a_sync_span(traced, kind):
    events = traced[kind][0]
    syncs = _spans(events, "tpugs.sync.")
    twins = [s for s in _spans(events) if s["name"] in TWIN_STAGES]
    (call,) = _spans(events, "tpugs.lift.call")
    reads = [e for e in events if e["name"] in HOST_READS and _inside(e, call)]
    assert reads and syncs
    assert [e["name"] for e in reads if not any(_inside(e, s) for s in syncs + twins)] == []
    assert any(_inside(e, s) for e in reads for s in syncs)


def test_untraced_lift_opens_no_span_and_matches_the_traced(traced, inputs, monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    marks = []
    HOST_TIMES.reset()
    num, den = _lift(inputs, on_stage=marks.append, cam_weights=torch.ones(VIEWS))
    assert marks == list(STAGES) * VIEWS
    assert len(HOST_TIMES.seconds[ENCODE]) == VIEWS and HOST_TIMES.median_ms(ENCODE) > 0
    _, num_t, den_t, _ = traced["views"]
    assert torch.equal(num, num_t) and torch.equal(den, den_t)


@pytest.mark.parametrize("engine", ["pallas", "scatter"])
def test_work_counts_each_view(inputs, engine):
    scene, cams, enc = inputs
    for c in range(VIEWS):
        WORK.reset()
        r = run_view(scene, cams.viewmats[c], cams.Ks[c], W, H, enc, TILE,
                     reduce_engine=engine)
        assert WORK.snapshot() == {
            "calls": 1, "slots": r.plan.T_padded, "isects": r.plan.n_isects,
            "walked_slots": BLOCK * int(r.blocks_done.sum())}
        assert 0 < WORK.snapshot()["walked_slots"] <= r.plan.T_padded
    WORK.reset()
    render_tiles(r.packed, r.plan)
    assert WORK.snapshot()["walked_slots"] == 0  # B1's wrapper counts nothing


def test_trace_writes_the_bodys_counters(traced):
    for kind in ("views", "split"):
        work = traced[kind][3]["work"]
        assert work["calls"] == VIEWS and 0 < work["walked_slots"] <= work["slots"]
        assert traced[kind][3]["launches"]["adjoint"] == 0  # the twins launch nothing
