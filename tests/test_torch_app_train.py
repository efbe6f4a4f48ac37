"""The train app: ``tpugs_torch.apps.train.main`` (``--device cpu``) against
tpugs' ``tpugs.apps.train.main`` in-process at the verify skill's size (a
COLMAP model of 4 orbit views at 64x48 rendered from a 150-Gaussian
scene, features 8 -> 4, ``linear:4``), both on the tiled engine (no early
exit), and the supervisor.

* per step with strategy "none", and ``--chunked`` with strategy "default"
  and ``--steps-scaler 0.02`` (11 steps in chunks of 2; one refine after
  step 10, N padded to the app's capacity multiple 16384): every printed
  step line's losses within rtol 2e-3 (+ 1e-4 for the 4-decimal print)
  and its N equal, every "refine @" line equal, the final eval's PSNR and
  SSIM within rtol 2e-3 (the step after a refine starts fresh Adam
  moments, whose first update, lr * sign(g), magnifies rounding), and the
  same files written under the result directory. A second refine in the
  same run flipped one split decision out of 171 (a Gaussian at the
  threshold), so the run refines once;
* ``apps.train_supervised``: a run whose child is killed after step 5
  (planted through a wrapper interpreter) resumes from ``ckpts/full_4.npz``
  at step 5 and finishes with the final files.
"""

import json
import os
import re
import sys

import numpy as np
import pytest

from tpugs.apps.train import main as j_main
from tpugs_torch.apps import train_supervised
from tpugs_torch.apps.train import main as t_main
from tpugs_torch.utils.synthetic import orbit_cameras, random_scene, write_synthetic_colmap
from tpugs_torch.viz.gif import render_to_gif

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = dict(data_factor=1, feature_dim=8, feature_out_dim=4, teacher="linear:4", test_every=4,
            eval_every=0, save_every=0, raster_engine="tiled")
CASES = {
    "per-step none": dict(strategy="none", max_steps=6),
    "chunked default": dict(strategy="default", chunked=True, max_steps=550, steps_scaler=0.02),
}
STEP = re.compile(r"^step (\d+) loss ([\d.]+) l1 ([\d.]+) feat ([\d.]+) N (\d+) [\d.]+ it/s$")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    imageio = pytest.importorskip("imageio.v2")
    root = str(tmp_path_factory.mktemp("vds") / "data")
    # the port's writers and render: the same files as tpugs' (the verify
    # skill's recipe), without compiling tpugs' renderer
    scene = random_scene(150, seed=0, extent=0.8, scale_range=(0.02, 0.1), device="cpu")
    cams = orbit_cameras(4, 64, 48, radius=2.5, device="cpu")
    os.makedirs(f"{root}/images", exist_ok=True)
    write_synthetic_colmap(root, cams)
    for i, f in enumerate(render_to_gif(None, scene, cams, save_frames=False)):
        imageio.imwrite(f"{root}/images/frame_{i:04d}.jpg", f)
    return root


def _lines(text):
    steps = [m.groups() for m in map(STEP.match, text.splitlines()) if m]
    refines = [line for line in text.splitlines() if line.startswith("refine @")]
    return steps, refines


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_app_matches_tpugs(case, data_dir, tmp_path, capsys):
    kw = {**ARGS, **CASES[case]}
    j_main(data_dir=data_dir, result_dir=str(tmp_path / "j"), **kw)
    ref = capsys.readouterr().out
    with pytest.MonkeyPatch.context() as m:  # as on the card's machine: traj.gif all the same
        for name in ("imageio", "matplotlib"):
            m.setitem(sys.modules, name, None)
        trainer = t_main(data_dir=data_dir, result_dir=str(tmp_path / "t"), device="cpu", **kw)
    got = capsys.readouterr().out
    (ref_steps, ref_refines), (steps, refines) = _lines(ref), _lines(got)
    assert len(steps) == len(ref_steps) > 0, got
    for a, b in zip(steps, ref_steps):
        assert a[0] == b[0] and a[4] == b[4], (a, b)
        np.testing.assert_allclose(np.float64(a[1:4]), np.float64(b[1:4]), rtol=2e-3, atol=1e-4)
    assert refines == ref_refines
    if kw["strategy"] == "default":
        assert len(refines) == 1 and steps[-1][4] == "16384"
    assert trainer.step == int(kw["max_steps"] * kw.get("steps_scaler", 1.0))
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    last = trainer.step - 1
    assert f"ckpts/full_{last}.npz" in _files(tmp_path / "t") and "traj.gif" in _files(
        tmp_path / "t")
    ours = json.loads((tmp_path / "t" / "stats" / "val_final.json").read_text())
    want = json.loads((tmp_path / "j" / "stats" / "val_final.json").read_text())
    assert ours["num_GS"] == want["num_GS"]
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(ours[k], want[k], rtol=2e-3, err_msg=k)


def test_supervisor_resumes_after_a_crash(data_dir, tmp_path, monkeypatch, capfd):
    """The child is the real app in a new interpreter; a wrapper kills the
    first attempt (exit 3) right after step 5, past the save at step 4."""
    marker = tmp_path / "crashed"
    wrapper = tmp_path / "python"
    wrapper.write_text(f"""#!{sys.executable}
import os, runpy, sys
if not os.path.exists({str(marker)!r}):
    open({str(marker)!r}, "w").close()
    import tpugs_torch.train.trainer as T
    step = T.Trainer.train_step
    def crashing(self, *a, **k):
        out = step(self, *a, **k)
        if self.step == 6:
            os._exit(3)
        return out
    T.Trainer.train_step = crashing
assert sys.argv[1:3] == ["-m", "tpugs_torch.apps.train"], sys.argv
sys.argv = [sys.argv[0]] + sys.argv[3:]
runpy.run_module("tpugs_torch.apps.train", run_name="__main__", alter_sys=True)
""")
    wrapper.chmod(0o755)
    monkeypatch.setattr(sys, "executable", str(wrapper))
    monkeypatch.setenv("PYTHONPATH", REPO)
    out = str(tmp_path / "out")
    rc = train_supervised.main([
        "--retries", "2", "--backoff-s", "0", "--", "--device", "cpu", "--data-dir", data_dir,
        "--result-dir", out, "--data-factor", "1", "--max-steps", "8", "--feature-dim", "8",
        "--feature-out-dim", "4", "--teacher", "linear:4", "--strategy", "none",
        "--test-every", "4", "--eval-every", "0", "--save-every", "2"])
    text = capfd.readouterr().out
    assert rc == 0 and marker.exists(), text
    assert "rc=3; resuming from" in text and "training completed" in text
    assert re.search(r"resumed from \S*full_4\.npz at step 5", text), text
    files = _files(out)
    assert {"ckpts/full_4.npz", "ckpts/full_6.npz", "ckpts/full_7.npz", "ckpts/ckpt_7.npz",
            "stats/val_final.json"} <= set(files)
    assert train_supervised.latest_full_ckpt(out).endswith("full_7.npz")
