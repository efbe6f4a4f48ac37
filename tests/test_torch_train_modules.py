"""The trainer's pose and appearance modules: ``train/modules.py`` against
tpugs' Flax modules, and the port's ``Trainer`` with ``pose_opt``,
``pose_noise`` and ``app_opt`` against tpugs' (Pallas engine in interpret
mode, ``pallas_trans_eps`` 0, 64x48, 120 Gaussians, features 8 -> 4).

* ``rotation_6d_to_matrix``, ``CameraOptModule`` and
  ``AppearanceOptModule`` (from tpugs' params by ``appearance_from_flax``)
  within 1e-6;
* three ``train_step``s: losses within rtol 2e-3 (the train tests'
  tolerance), then the pose deltas and the appearance params within 1e-5
  of tpugs'; the noise is the same draw;
* the colormaps equal to tpugs'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.encoders import get_encoder as j_get_encoder
from tpugs.train import modules as jm
from tpugs.train.config import TrainConfig as JTrainConfig
from tpugs.train.trainer import Trainer as JTrainer
from tpugs.train.trainer import init_scene_from_points as j_init
from tpugs.utils.synthetic import orbit_cameras
from tpugs_torch.convert import appearance_from_flax
from tpugs_torch.train import modules as tm
from tpugs_torch.train.config import TrainConfig
from tpugs_torch.train.trainer import Trainer, init_scene_from_points

W, H, N, STEPS = 64, 48, 120, 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_rotation_6d_to_matrix_matches_tpugs():
    d6 = np.random.default_rng(0).normal(size=(7, 5, 6)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.rotation_6d_to_matrix)(jnp.asarray(d6)))
    got = tm.rotation_6d_to_matrix(torch.from_numpy(d6)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    eye = tm.rotation_6d_to_matrix(torch.tensor(tm.IDENTITY_POSE[:6]))
    assert torch.equal(eye, torch.eye(3))


def test_camera_opt_module_matches_tpugs():
    rng = np.random.default_rng(1)
    c2w = rng.normal(size=(4, 4, 4)).astype(np.float32)
    ids = np.array([0, 2, 2, 1])
    mod = jm.CameraOptModule(n_cameras=3)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(c2w), jnp.asarray(ids))
    ours = tm.CameraOptModule(3, device="cpu")
    np.testing.assert_array_equal(ours.pose_deltas.detach().numpy(),
                                  np.asarray(params["params"]["pose_deltas"]))
    deltas = (np.asarray(params["params"]["pose_deltas"])
              + rng.normal(0, 0.1, (3, 9))).astype(np.float32)
    ref = mod.apply({"params": {"pose_deltas": jnp.asarray(deltas)}}, jnp.asarray(c2w),
                    jnp.asarray(ids))
    with torch.no_grad():
        ours.pose_deltas.copy_(torch.from_numpy(deltas))
        got = ours(torch.from_numpy(c2w), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("embed", [1, None])
def test_appearance_module_matches_tpugs(embed):
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(50, 8)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    mod = jm.AppearanceOptModule(n_images=3, feature_dim=8, embed_dim=16, sh_degree=3)
    params = mod.init(jax.random.PRNGKey(4), jnp.asarray(feats), jnp.int32(0), jnp.asarray(dirs))
    # non-zero embeddings, so that the embedding path counts
    params = {"params": {**params["params"], "embeds": jnp.asarray(
        rng.normal(size=(3, 16)).astype(np.float32))}}
    ref = mod.apply(params, jnp.asarray(feats), None if embed is None else jnp.int32(embed),
                    jnp.asarray(dirs))
    ours = tm.AppearanceOptModule(3, 8, 16, 3, device="cpu")
    ours.load_state_dict(appearance_from_flax(_np_tree(params)))
    with torch.no_grad():
        got = ours(torch.from_numpy(feats), embed, torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_pose_and_appearance_steps_match_tpugs():
    kw = dict(max_steps=8, sh_degree=1, feature_dim=8, feature_out_dim=4, strategy="none",
              sh_degree_interval=100, random_bkgd=False, pallas_trans_eps=0.0, pose_opt=True,
              pose_noise=0.01, app_opt=True, seed=3)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    cams = orbit_cameras(STEPS, W, H, radius=2.5)
    teacher = j_get_encoder("linear:4")
    jt = JTrainer(JTrainConfig(raster_engine="pallas", **kw), j_init(pts, rgbs, JTrainConfig(**kw)),
                  1.0, width=W, height=H, n_cameras=STEPS)
    pt = Trainer(TrainConfig(**kw), init_scene_from_points(pts, rgbs, TrainConfig(**kw),
                                                           device="cpu"),
                 1.0, width=W, height=H, n_cameras=STEPS, device="cpu")
    np.testing.assert_array_equal(pt.pose_perturb.numpy(), np.asarray(jt.pose_perturb))
    np.testing.assert_array_equal(pt.app_module.out.weight.detach().numpy(), 0.0)
    # tpugs draws its Dense inits from jax.random: start the port from them
    pt.app_module.load_state_dict(appearance_from_flax(_np_tree(jt.app_params)))
    for c in range(STEPS):
        image = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        batch = {"viewmat": np.array(cams.viewmats[c]), "K": np.array(cams.Ks[c]),
                 "image": image, "image_id": c}
        feats = np.array(teacher(jnp.asarray(image)))
        ref = jt.train_step(batch, teacher_feats=jnp.asarray(feats))
        got = pt.train_step(batch, teacher_feats=feats)
        for k in ("loss", "l1", "ssim_loss", "feature_l1"):
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-3, err_msg=f"step {c} {k}")
    ref_pose = np.asarray(jt.pose_params)
    assert np.abs(ref_pose - np.tile(tm.IDENTITY_POSE, (STEPS, 1))).max() > 0
    np.testing.assert_allclose(pt.pose_params.detach().numpy(), ref_pose, rtol=0, atol=1e-5)
    ref_app = appearance_from_flax(_np_tree(jt.app_params))
    got_app = pt.app_module.state_dict()
    assert float(ref_app["out.weight"].abs().max()) > 0
    for k, v in ref_app.items():
        np.testing.assert_allclose(got_app[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_colormaps_match_tpugs():
    d = np.linspace(0.2, 3.0, 96).reshape(8, 12)
    acc = np.random.default_rng(6).uniform(0, 1, (8, 12))
    np.testing.assert_array_equal(tm.apply_float_colormap(d / 3), jm.apply_float_colormap(d / 3))
    np.testing.assert_array_equal(tm.apply_depth_colormap(d, acc),
                                  jm.apply_depth_colormap(d, acc))
    np.testing.assert_array_equal(tm.apply_depth_colormap(d, near=0.5, far=2.0),
                                  jm.apply_depth_colormap(d, near=0.5, far=2.0))
