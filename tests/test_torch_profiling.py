"""The port's profiling (``tpugs_torch.utils.profiling``,
``experiments/profile_stages.py``) against tpugs' on the CPU.

* the roofline arithmetic (``kernel_stats``, ``roofline_report``, the
  workload models, ``sol_estimate``) equal to tpugs' exactly, at tpugs'
  own peaks and gather rate, which the test imports from tpugs and hands
  to both; the port's defaults are the H100's, with the gather at its HBM
  rate;
* ``StageTimer`` rows equal to tpugs' at those peaks; ``trace`` writes a
  Chrome trace with the body's annotation, is a no-op without a
  directory and raises when the profiler cannot start;
  ``device_memory_stats("cpu")`` is None;
* ``device_idle_share`` and ``kernel_times`` on a hand-written trace with
  overlapping kernels, a copy and a memset, whose union is known;
* ``profile_stages``' two unpermutes (the XLA reduce's write-back and
  the reference's gather) bit-equal to ``reduce_contribs_xla``, which is
  within f32 rounding of B3's twin;
* ``profile_stages.main`` at 200 Gaussians, 64x48: the full view's
  ``num`` and ``den`` equal ``run_view``'s, the unpermutes bit-equal;
  ``eager_lift_split``'s field bit-equal to ``create_feature_field``'s.
"""

import json
import os

import numpy as np
import pytest
import torch

from pathlib import Path

from tpugs.utils import profiling as jprof
from tpugs_torch.utils import profiling as tprof

REPO = Path(__file__).resolve().parent.parent

KERNEL_CASES = [
    ("stream", 0.01, 1e6, 1e9, "bf16"),
    ("mxu", 0.01, 1e12, 1e9, "bf16"),
    ("f32", 0.003, 5e10, 2e8, "f32"),
    ("zero-time", 0.0, 1e9, 1e6, "bf16"),
    ("no-bytes", 0.5, 1e9, 0.0, "f32"),
    ("ridge", 1.0, jprof.PEAKS_V5E["tflops_bf16"] * 1e12 / (jprof.PEAKS_V5E["hbm_gbps"] * 1e9),
     1.0, "bf16"),
]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_kernel_stats_equal_tpugs_at_its_peaks(case):
    name, s, flops, hbm, dtype = case
    got = tprof.kernel_stats(name, s, flops, hbm, dtype=dtype, peaks=jprof.PEAKS_V5E)
    assert got == jprof.kernel_stats(name, s, flops, hbm, dtype=dtype)


def test_roofline_report_equals_tpugs():
    rows = [jprof.kernel_stats(*c[:4], dtype=c[4]) for c in KERNEL_CASES]
    assert tprof.roofline_report(rows) == jprof.roofline_report(rows)
    assert tprof.roofline_report([]) == jprof.roofline_report([])


def test_workload_models_equal_tpugs():
    for n_isect, n_pix, d in ((1000, 10000, 3), (1855232, 1088640, 7), (0, 64, 1)):
        assert tprof.render_model(n_isect, n_pix, d) == jprof.render_model(n_isect, n_pix, d)
        assert tprof.adjoint_model(n_isect, d) == jprof.adjoint_model(n_isect, d)
        assert tprof.reduce_model(n_isect, d) == jprof.reduce_model(n_isect, d)
    assert tprof.lseg_encoder_model() == jprof.lseg_encoder_model()
    kw = dict(crop=224, patch=14, width=384, layers=12, head_features=128, out_dim=64,
              bytes_per_param=4.0)
    assert tprof.lseg_encoder_model(**kw) == jprof.lseg_encoder_model(**kw)


@pytest.mark.parametrize("kw", [{}, {"slot_rows": 1_700_000},
                                {"encode_model": "lseg"}], ids=["plain", "slots", "lseg"])
def test_sol_estimate_equals_tpugs_at_its_rates(kw):
    if "encode_model" in kw:
        kw = {"encode_model": jprof.lseg_encoder_model()}
    args = (1855232, 1296 * 840, 512)
    got = tprof.sol_estimate(*args, gather_gbps=jprof.GATHER_FLOOR_GBPS,
                             peaks=jprof.PEAKS_V5E, **kw)
    assert got == jprof.sol_estimate(*args, **kw)


def test_port_defaults_are_the_h100s():
    assert tprof.PEAKS_H100 == {"tflops_bf16": 989.0, "tflops_f32": 67.0, "hbm_gbps": 3350.0}
    args = (1855232, 1296 * 840, 512)
    assert tprof.sol_estimate(*args) == jprof.sol_estimate(
        *args, gather_gbps=3350.0, peaks=tprof.PEAKS_H100)
    s = tprof.kernel_stats("stream", 0.01, 1e6, 1e9)
    assert s["bound"] == "memory" and np.isclose(s["pct_peak"], 100.0 * 100.0 / 3350.0)
    assert not hasattr(tprof, "GATHER_FLOOR_GBPS") and not hasattr(tprof, "PEAKS_V5E")


def test_stage_timer_rows_equal_tpugs_and_report():
    t = tprof.StageTimer(device="cpu", peaks=dict(jprof.PEAKS_V5E))
    j = jprof.StageTimer()
    for args in (("manual", 0.005, 0.0, 5e8), ("dense", 0.02, 3e12, 1e9)):
        t.add(*args)
        j.add(*args)
    assert t.rows == j.rows and t.report() == j.report()
    with t.stage("warm", flops=1e9, hbm_bytes=1e6):
        np.dot(np.ones((100, 100)), np.ones((100, 100)))
    rep = t.report()
    assert "warm" in rep and len(rep.splitlines()) == 5  # header + rule + 3 rows
    assert t.rows[-1]["seconds"] > 0 and t.device == torch.device("cpu")
    t.add("manual", 0.001)
    assert t.totals() == {"manual": 0.006, "dense": 0.02, "warm": t.rows[2]["seconds"]}


def test_trace_writes_chrome_trace_and_noop(tmp_path):
    with tprof.trace(None) as path:
        assert path is None
    with tprof.trace("") as path:
        assert path is None
    with tprof.trace(str(tmp_path / "tr")) as path:
        with tprof.annotation("body"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    assert path == str(tmp_path / "tr" / "trace.json") and os.path.isfile(path)
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e.get("name") == "body" for e in events)
    idle = tprof.device_idle_share(path)
    assert idle["events"] == 0 and idle["idle_share"] == 1.0 and idle["window_ms"] > 0
    assert tprof.device_memory_stats("cpu") is None


def test_trace_raises_when_the_profiler_cannot_start(tmp_path, monkeypatch):
    class Refused:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("CUPTI refused")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Refused)
    with pytest.raises(RuntimeError, match="CUPTI refused"):
        with tprof.trace(str(tmp_path / "tr")):
            pass


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


HAND_TRACE = {"traceEvents": [
    _x("user_annotation", "lift", 100.0, 900.0),  # window [100, 1000)
    _x("cpu_op", "aten::mm", 120.0, 50.0),
    _x("kernel", "void tpugs::(anonymous namespace)::render_kernel<1>(float*)", 50.0, 100.0),
    _x("kernel", "void tpugs::(anonymous namespace)::adjoint_kernel<2>(float*)", 200.0, 200.0),
    _x("kernel", "void at::native::reduce_kernel<512, 1>(float*)", 350.0, 100.0),
    _x("gpu_memcpy", "Memcpy DtoH", 600.0, 50.0),
    _x("gpu_memset", "Memset", 640.0, 60.0),
    _x("kernel", "void tpugs::(anonymous namespace)::reduce_kernel<float>(float*)", 900.0, 300.0),
    _x("kernel", "void tpugs::(anonymous namespace)::render_kernel<1>(float*)", 2000.0, 10.0),
    {"ph": "M", "name": "process_name", "args": {"name": "gpu"}},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 500.0},
]}


def test_device_idle_share_on_a_hand_written_trace(tmp_path):
    # union over [100, 1000): [100,150) + [200,450) + [600,700) + [900,1000) = 500 us
    got = tprof.device_idle_share(HAND_TRACE)
    assert got == {"idle_share": pytest.approx(4 / 9, abs=1e-15), "busy_ms": 0.5,
                   "window_ms": 0.9, "events": 6}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(HAND_TRACE))
    assert tprof.device_idle_share(str(path)) == got
    # an explicit window: [0, 2100) holds all seven device intervals
    full = tprof.device_idle_share(HAND_TRACE, window=(0.0, 2100.0))
    assert full["events"] == 7 and np.isclose(full["busy_ms"], 0.76)
    with pytest.raises(ValueError):
        tprof.device_idle_share({"traceEvents": HAND_TRACE["traceEvents"][1:]})


def test_kernel_times_by_name():
    assert tprof.kernel_times(HAND_TRACE, r"tpugs::.*\brender_kernel\b") == (2, 0.11)
    assert tprof.kernel_times(HAND_TRACE, r"tpugs::.*\breduce_kernel\b") == (1, 0.3)
    assert tprof.kernel_times(HAND_TRACE, r"\breduce_kernel\b") == (2, 0.4)
    assert tprof.kernel_times(HAND_TRACE, "Memcpy") == (0, 0.0)


@pytest.fixture(scope="module")
def stages():
    from tpugs_torch.experiments import profile_stages

    return profile_stages.main(["--num-gaussians", "200", "--width", "64", "--height", "48",
                                "--feature-dim", "8", "--tile", "16", "--iters", "2",
                                "--plan-breakdown", "--device", "cpu"])


def test_profile_stages_full_view_equals_run_view(stages):
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import run_view
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    scene = random_scene(200, seed=0, extent=1.0, scale_range=(0.004, 0.02), device="cpu")
    cams = orbit_cameras(4, 64, 48, radius=3.0, device="cpu")
    r = run_view(scene, cams.viewmats[0], cams.Ks[0], 64, 48, LinearRGBEncoder(8, device="cpu"),
                 16)
    assert torch.equal(stages["num"], r.num) and torch.equal(stages["den"], r.den)
    assert float(r.den.sum()) > 0
    assert stages["sizes"]["n_isects"] == r.plan.n_isects
    assert stages["sizes"]["T_padded"] == r.plan.T_padded
    assert set(stages["plan_ms"]) == {"plan/bboxes+cull", "plan/sort", "plan/slot table",
                                      "plan/csr"}
    assert stages["roofline"] is None and stages["memory"] is None and stages["trace"] is None
    assert stages["sol"]["total"] > 0
    for label in ("plan", "render kernel (B1)", "adjoint kernel (B2, bf16)", "reduce (B3)",
                  "reduce (xla)", "unpermute (write-back)", "unpermute (gather)",
                  "FULL view (run_view)"):
        assert stages["ms"][label] > 0


def test_profile_stages_unpermutes_bit_equal(stages):
    sums = stages["sums"]
    assert torch.equal(sums["gather"], sums["write-back"])
    assert torch.equal(sums["gather"], sums["xla"])
    np.testing.assert_allclose(sums["xla"].numpy(), sums["pallas"].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_reduce_xla_unpermutes_on_a_lift_view():
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import run_view
    from tpugs_torch.experiments.profile_stages import unpermute_gather, unpermute_write_back
    from tpugs_torch.raster.plan import slot_columns
    from tpugs_torch.raster.reduce import reduce_contribs_xla
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    scene = random_scene(150, seed=3, extent=0.8, scale_range=(0.02, 0.1), device="cpu")
    cams = orbit_cameras(2, 64, 48, radius=2.5, device="cpu")
    r = run_view(scene, cams.viewmats[1], cams.Ks[1], 64, 48, LinearRGBEncoder(5, device="cpu"),
                 16, contrib_dtype=torch.float32)
    xla = reduce_contribs_xla(r.rows, r.plan, 6)
    order, _ = slot_columns(r.plan)
    assert not torch.equal(order, torch.arange(order.shape[0]))  # a real permutation
    acc = xla[order]
    g, s = unpermute_gather(acc, order), unpermute_write_back(acc, order)
    assert torch.equal(g, s) and torch.equal(g, xla)
    np.testing.assert_allclose(xla.numpy(), r.sums.numpy(), rtol=1e-5, atol=1e-6)


def test_eager_lift_split_equals_create_feature_field():
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.experiments.profile_stages import eager_lift_split
    from tpugs_torch.lift.backproject import create_feature_field
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    scene = random_scene(150, seed=1, extent=0.8, scale_range=(0.02, 0.1), device="cpu")
    cams = orbit_cameras(2, 56, 40, radius=2.5, device="cpu")
    enc = LinearRGBEncoder(6, device="cpu")
    timer = tprof.StageTimer(device="cpu")
    got = eager_lift_split(scene, cams, enc, timer)
    ref = create_feature_field(scene, cams, enc, verbose=False, device="cpu")
    assert torch.equal(got, ref) and float(ref.abs().sum()) > 0
    assert list(timer.totals()) == ["project+sh", "plan", "pack", "B4", "encode", "B2", "B3",
                                    "accumulate", "normalise"]
    assert len(timer.rows) == 2 * 9 + 1


def test_port_holds_no_tpu_figure():
    """The port's peaks and rates are the H100's: no TPU peak, gather
    floor or TPU-measured rate is copied into it."""
    import re

    files = sorted((REPO / "tpugs_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [(str(f.relative_to(REPO)), m.group(0)) for f in files
           for m in re.finditer(r"PEAKS_V5E|GATHER_FLOOR|\bv5e\b|\b819(\.0)? ?GB/s|\b46(\.0)? GB/s",
                                f.read_text(), flags=re.I)]
    assert not bad, bad
