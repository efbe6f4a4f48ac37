"""Three checks against tpugs on the CPU that span modules:

* ``utils/synthetic.py::random_scene_arrays`` draws tpugs' ``random_scene``
  bit for bit at ``feature_dim`` None, 0 and 6 (the features come last);
* ``train/dataset.py::Parser`` and ``Dataset`` on one OPENCV_FISHEYE and
  one SIMPLE_RADIAL view as ``tests/test_undistort.py`` builds them: the
  same parse as tpugs' (K, size, remap grids, images), the fisheye
  remap recovering the ideal image as that test requires, and the
  rectified K and size that ``test_fisheye_k_and_size_updated`` checks;
* the user chain of ``tests/test_integration_colmap.py`` on its
  PINHOLE + OPENCV + OPENCV_FISHEYE rig, each of the port's steps held to
  tpugs' step on the port's previous output: the parse; ``apps/train.py``
  for 4 steps, whose ``ckpt_3.npz`` tpugs' reader loads, finite;
  ``apps/backproject.py`` on the rig's ``ckpt.pt`` (prune, verify, the
  eager lift), against tpugs' unsharded ``backproject_views`` on the
  pruned scene and the loaded cameras to a relative L2 error of 1e-2 per
  Gaussian (``test_torch_app_backproject.py``'s bound); ``apps/segment.py``
  whose mask equals tpugs' ``get_mask3d`` on that field. tpugs' own apps
  are not rerun (its train app compiles per run).
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_integration_colmap import _build_dataset
from tests.test_torch_train_io import _same_parser
from tests.test_undistort import (
    CX,
    CY,
    FX,
    FY,
    _distort_image,
    _expected_at_newk,
    _ideal_image,
    _write_dataset,
)
from tpugs.core.camera import Camera as JCamera
from tpugs.core.scene import GaussianScene as JScene
from tpugs.encoders.base import LinearRGBEncoder as JLinear
from tpugs.io import checkpoints as jck
from tpugs.lift.batch import backproject_views as j_backproject_views
from tpugs.lift.batch import estimate_sizes, normalize_field
from tpugs.query.text import get_mask3d as j_get_mask3d
from tpugs.train import dataset as jd
from tpugs.utils import synthetic as jsyn
from tpugs_torch.train import dataset as td
from tpugs_torch.utils import synthetic as tsyn


@pytest.mark.parametrize("feature_dim", [None, 0, 6])
def test_random_scene_draws_match_tpugs(feature_dim):
    js = jsyn.random_scene(40, seed=3, extent=0.7, scale_range=(0.02, 0.1), sh_degree=2,
                           feature_dim=feature_dim)
    ours = tsyn.random_scene_arrays(40, seed=3, extent=0.7, scale_range=(0.02, 0.1),
                                    sh_degree=2, feature_dim=feature_dim)
    ref = {k: np.asarray(getattr(js, k)) for k in
           ("means", "quats", "log_scales", "logit_opacities", "sh0", "shN", "features")
           if getattr(js, k) is not None}
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    scene = tsyn.random_scene(40, seed=3, extent=0.7, scale_range=(0.02, 0.1), sh_degree=2,
                              feature_dim=feature_dim, device="cpu")
    assert (scene.features is None) == (not feature_dim)


CAMERA_MODELS = {
    "fisheye": ("OPENCV_FISHEYE", [FX, FY, CX, CY, -0.08, 0.02, 0.0, 0.0], True, 30),
    "simple_radial": ("SIMPLE_RADIAL", [FX, CX, CY, -0.12], False, 12),
}


@pytest.mark.parametrize("kind", sorted(CAMERA_MODELS))
def test_parser_matches_tpugs_on_more_camera_models(kind, tmp_path):
    model, params, fisheye, m = CAMERA_MODELS[kind]
    dist = np.array((params[4:] if fisheye else [params[3], 0.0, 0.0, 0.0]), np.float64)
    ideal = _ideal_image()
    data_dir = _write_dataset(tmp_path, model, params, _distort_image(ideal, dist, fisheye))
    ours, ref = td.Parser(data_dir, factor=1), jd.Parser(data_dir, factor=1)
    _same_parser(ours, ref)
    a, b = td.Dataset(ours, "val")[0], jd.Dataset(ref, "val")[0]  # the one image is view 0
    for k in ("image", "K", "viewmat"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
    # the remap recovers the ideal image at the rectified K and size
    assert 1 in ours.mapx_dict and 1 in ours.roi_undist_dict
    rw, rh = ours.imsize_dict[1]
    expected = _expected_at_newk(ideal, ours.Ks_dict[1], rw, rh).astype(np.float32) / 255.0
    err = np.abs(ours.load_image(0)[m:-m, m:-m] - expected[m:-m, m:-m])
    assert float(np.mean(err)) < 0.02 and float(np.percentile(err, 99)) < 0.08
    assert ours.Ks_dict[1].shape == (3, 3)
    assert ours.Ks_dict[1][0, 0] == pytest.approx(FX, rel=0.5)


def test_chain_matches_tpugs_steps(tmp_path):
    from tpugs_torch.apps.backproject import main as bp_main
    from tpugs_torch.apps.segment import main as seg_main
    from tpugs_torch.apps.train import main as train_main
    from tpugs_torch.io.checkpoints import load_checkpoint
    from tpugs_torch.lift.prune import prune_by_gradients

    data_dir, _ = _build_dataset(tmp_path)
    # the parse: every model of the rig, as tpugs parses it
    ours, ref = td.Parser(data_dir, factor=1), jd.Parser(data_dir, factor=1)
    _same_parser(ours, ref)
    assert set(ours.Ks_dict) == {1, 2, 3} and set(ours.mapx_dict) == {2, 3}

    out_dir = str(tmp_path / "out")
    train_main(data_dir=data_dir, result_dir=out_dir, data_factor=1, max_steps=4, feature_dim=4,
               feature_out_dim=4, teacher="linear:4", strategy="none", test_every=6,
               eval_every=0, save_every=0, sh_degree=1, init_type="sfm", seed=0, device="cpu")
    trained = jck.load_scene_npz(os.path.join(out_dir, "ckpts", "ckpt_3.npz"))
    for k in ("means", "quats", "log_scales", "logit_opacities", "sh0", "shN", "features"):
        assert np.isfinite(np.asarray(getattr(trained, k))).all(), k

    res_dir, ckpt = str(tmp_path / "results"), os.path.join(data_dir, "ckpt.pt")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        feats = bp_main(data_dir=data_dir, checkpoint=ckpt, results_dir=res_dir, data_factor=1,
                        feature="linear:8", batch=False, device="cpu")
    assert "max pixel error = 0.0," in log.getvalue(), log.getvalue()
    got = np.load(os.path.join(res_dir, "features_linear:8.npz"))["features"]
    np.testing.assert_array_equal(got, np.asarray(feats))
    scene, cams, _ = load_checkpoint(ckpt, data_dir, "gsplat", 1, "cpu")
    pruned = prune_by_gradients(scene, cams, device="cpu")
    js = JScene(**{k: jnp.asarray(getattr(pruned, k).numpy()) for k in
                   ("means", "quats", "log_scales", "logit_opacities", "sh0", "shN")})
    vms, ks = jnp.asarray(cams.viewmats.numpy()), jnp.asarray(cams.Ks.numpy())
    enc = JLinear(feature_dim=8)
    sizes = estimate_sizes(js, JCamera(vms, ks, cams.width, cams.height))
    ref = np.asarray(normalize_field(*j_backproject_views(
        js, vms, ks, cams.width, cams.height, enc, sizes)))
    assert got.shape == ref.shape == (pruned.num_gaussians, 8)
    lit = np.abs(ref).sum(1) > 0
    np.testing.assert_array_equal(np.abs(got).sum(1) > 0, lit)
    assert lit.sum() > 100
    rel = np.linalg.norm(got[lit] - ref[lit], axis=1) / np.linalg.norm(ref[lit], axis=1)
    assert rel.max() <= 1e-2, rel.max()

    mask = seg_main(data_dir=data_dir, checkpoint=ckpt, results_dir=res_dir, data_factor=1,
                    feature="linear:8", pos_idx="0,1", neg_idx="5,6", export_checkpoint=True,
                    skip_prune=True, device="cpu")
    f = jnp.asarray(got)
    j_mask, _ = j_get_mask3d(f, f[jnp.array([0, 1])], f[jnp.array([5, 6])])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert 0 < int(mask.sum()) < len(got)
    for name in ("mask2d.gif", "extracted.gif", "deleted.gif", "extracted.pt"):
        assert os.path.exists(os.path.join(res_dir, name)), name
