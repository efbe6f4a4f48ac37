"""The port's back-projection app (``tpugs_torch.apps.backproject``, on
``device="cpu"``) against tpugs' app (JAX on the CPU, its Pallas kernels
in interpret mode) on one dataset written by tpugs: the 150-Gaussian
scene and 4-view 64x48 orbit rig of the repo's verify recipe
(``random_scene(150, seed=0, extent=0.8, scale_range=(0.02, 0.1))``,
``orbit_cameras(4, 64, 48, radius=2.5)``), COLMAP model and gsplat ``.pt``
(the app reads no images), plus 3 opaque Gaussians planted far outside
every view, which pruning must remove.

* each engine against tpugs' app with the same engine, ``linear:8``:
  ``eager`` and ``scan`` (f32 rows) to 1e-5 absolute; ``pallas`` (bf16
  rows on both sides, rounded in other places) to a relative L2 error of
  at most 1e-2 per Gaussian (a cosine of at least 0.99995; the worst
  measured on the CPU is 1.44e-3), the same Gaussians without a feature;
  both apps print "Pruned 3 splats" and "max pixel error = 0.0";
* ``--morton`` against the default order (``scan``): 1e-5 (float
  reassociation); ``--no-batch`` bit-equal to ``engine="eager"``;
* an unknown engine raises ValueError, ``lseg`` NotImplementedError
  naming ROADMAP item 2; ``strict_sizes`` prints that the port has no
  size buckets to audit and changes no feature;
* ``python -m tpugs_torch.apps.backproject --device cpu ... --no-batch``
  in a subprocess prints "max pixel error = 0.0" and saves the npz;
* ``utils/order.py`` and ``utils/cli.py`` against tpugs': Morton codes,
  permutations and permuted scenes equal; the same parsed arguments.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from tpugs.apps.backproject import main as j_main
from tpugs.core.scene import GaussianScene as JScene
from tpugs.io.checkpoints import save_scene_pt
from tpugs.utils import cli as jcli
from tpugs.utils import order as jorder
from tpugs.utils.synthetic import orbit_cameras, random_scene, write_synthetic_colmap
from tpugs_torch.apps.backproject import main as t_main
from tpugs_torch.convert import SCENE_FIELDS, scene_from_numpy, scene_to_numpy
from tpugs_torch.utils import cli as tcli
from tpugs_torch.utils import order as torder

REPO = Path(__file__).resolve().parent.parent
PLANTED = 3
FEATURE = "linear:8"


def _planted_scene():
    js = random_scene(150, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    extra = dict(
        means=np.tile([[0.0, 100.0, 0.0]], (PLANTED, 1)),
        quats=np.tile([[1.0, 0.0, 0.0, 0.0]], (PLANTED, 1)),
        log_scales=np.full((PLANTED, 3), -3.0),
        logit_opacities=np.full((PLANTED,), 2.0),
        sh0=np.ones((PLANTED, 1, 3)),
        shN=np.zeros((PLANTED, 15, 3)),
    )
    return JScene(**{k: jnp.concatenate([getattr(js, k), jnp.asarray(v, jnp.float32)])
                     for k, v in extra.items()})


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("vds")
    data = root / "data"
    write_synthetic_colmap(str(data), orbit_cameras(4, 64, 48, radius=2.5))
    save_scene_pt(_planted_scene(), str(data / "ckpt.pt"))
    return root


def _run(main, dataset, tag, **kw):
    """(features, stdout) of one app run into its own results directory."""
    data = dataset / "data"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        feats = main(data_dir=str(data), checkpoint=str(data / "ckpt.pt"),
                     results_dir=str(dataset / tag), data_factor=1, feature=FEATURE, **kw)
    saved = np.load(dataset / tag / f"features_{FEATURE}.npz")["features"]
    np.testing.assert_array_equal(saved, np.asarray(feats))
    return saved, out.getvalue()


@pytest.mark.parametrize("engine", ["eager", "scan", "pallas"])
def test_app_matches_tpugs(dataset, engine):
    got, log = _run(t_main, dataset, f"port-{engine}", engine=engine, device="cpu")
    ref, j_log = _run(j_main, dataset, f"tpugs-{engine}", engine=engine)
    for text in (log, j_log):
        assert f"Pruned {PLANTED} splats" in text, text
        assert "max pixel error = 0.0," in text, text
    assert got.shape == ref.shape == (150, 8)
    if engine != "pallas":
        np.testing.assert_allclose(got, ref, atol=1e-5)
        return
    lit = np.abs(ref).sum(1) > 0
    np.testing.assert_array_equal(np.abs(got).sum(1) > 0, lit)
    assert lit.sum() > 100
    rel = np.linalg.norm(got[lit] - ref[lit], axis=1) / np.linalg.norm(ref[lit], axis=1)
    assert rel.max() <= 1e-2, rel.max()


def test_morton_order_matches_the_default(dataset):
    plain, _ = _run(t_main, dataset, "default", engine="scan", device="cpu")
    morton, _ = _run(t_main, dataset, "morton", engine="scan", morton=True, device="cpu")
    np.testing.assert_allclose(morton, plain, atol=1e-5)


def test_no_batch_is_eager(dataset):
    eager, _ = _run(t_main, dataset, "eager", engine="eager", device="cpu")
    no_batch, _ = _run(t_main, dataset, "no-batch", engine="pallas", batch=False, device="cpu")
    np.testing.assert_array_equal(no_batch, eager)


def test_unknown_engine_and_unported_encoders_raise(dataset):
    """Every encoder of tpugs' registry is ported now: an unknown engine or
    encoder name raises ValueError."""
    with pytest.raises(ValueError, match="unknown engine"):
        _run(t_main, dataset, "bad", engine="fast", skip_prune=True, device="cpu")
    with pytest.raises(ValueError, match="unknown encoder"):
        t_main(data_dir=str(dataset / "data"), checkpoint=str(dataset / "data" / "ckpt.pt"),
               results_dir=str(dataset / "clip"), data_factor=1, feature="clip",
               skip_prune=True, device="cpu")


@pytest.mark.parametrize("feature", ["lseg", "dino"])
def test_encoder_ckpt_and_device_reach_get_encoder(dataset, monkeypatch, feature):
    """``--feature lseg|dino --encoder-ckpt FILE``: the app hands the file
    and its device to ``get_encoder`` ("" means random weights: None)."""
    import tpugs_torch.encoders as registry
    from tpugs_torch.encoders.base import LinearRGBEncoder

    calls = []

    def fake(name, ckpt=None, device="cuda", dtype=None):
        calls.append((name, ckpt, str(device)))
        return LinearRGBEncoder(8, device=device)

    monkeypatch.setattr(registry, "get_encoder", fake)
    for ckpt in ("weights.ckpt", ""):
        t_main(data_dir=str(dataset / "data"), checkpoint=str(dataset / "data" / "ckpt.pt"),
               results_dir=str(dataset / f"enc-{feature}"), data_factor=1, feature=feature,
               encoder_ckpt=ckpt, skip_prune=True, engine="scan", device="cpu")
    assert calls == [(feature, "weights.ckpt", "cpu"), (feature, None, "cpu")]
    assert (dataset / f"enc-{feature}" / f"features_{feature}.npz").exists()


def test_strict_sizes_says_there_is_nothing_to_audit(dataset):
    plain, _ = _run(t_main, dataset, "not-strict", engine="eager", skip_prune=True,
                    device="cpu")
    strict, log = _run(t_main, dataset, "strict", engine="eager", skip_prune=True,
                       strict_sizes=True, device="cpu")
    assert "no size buckets; nothing to audit" in log, log
    np.testing.assert_array_equal(strict, plain)


def test_cli_subprocess_prints_max_pixel_error_zero(dataset):
    data, out = dataset / "data", dataset / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "tpugs_torch.apps.backproject", "--device", "cpu",
         "--data-dir", str(data), "--checkpoint", str(data / "ckpt.pt"),
         "--results-dir", str(out), "--data-factor", "1", "--feature", FEATURE, "--no-batch"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert "max pixel error = 0.0" in proc.stdout, proc.stdout
    assert (out / f"features_{FEATURE}.npz").exists()


def test_order_matches_tpugs():
    js = random_scene(300, seed=4)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}, device="cpu")
    pts = np.asarray(js.means)
    np.testing.assert_array_equal(torder.morton_codes(pts), jorder.morton_codes(pts))
    np.testing.assert_array_equal(torder.morton_codes(pts, 6), jorder.morton_codes(pts, 6))
    perm = torder.morton_permutation(ts)
    np.testing.assert_array_equal(perm, jorder.morton_permutation(js))
    inv = torder.inverse_permutation(perm)
    np.testing.assert_array_equal(inv, jorder.inverse_permutation(perm))
    np.testing.assert_array_equal(perm[inv], np.arange(300))
    got = scene_to_numpy(torder.permute_scene(ts, perm))
    ref = jorder.permute_scene(js, perm)
    for k in SCENE_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)), err_msg=k)


def _entry(name: str = "x", count: int = 3, scale: float = 0.5, flag: bool = False,
           on: bool = True, path: str = ""):
    """An entry point to parse for."""
    return dict(name=name, count=count, scale=scale, flag=flag, on=on, path=path)


@pytest.mark.parametrize("argv", [
    [],
    ["--name", "y", "--count", "7", "--scale", "2.5"],
    ["--flag", "--no-on", "--path", "/a/b"],
])
def test_cli_matches_tpugs(argv):
    assert tcli.cli(_entry, argv) == jcli.cli(_entry, argv)
    with pytest.raises(SystemExit):
        tcli.cli(_entry, ["--count", "many"])
