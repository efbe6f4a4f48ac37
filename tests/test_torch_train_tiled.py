"""The trainer's ``raster_engine="tiled"``: the port's ``Trainer``
(``device="cpu"``, ``render_tiled`` on the kernels' twins, no early exit,
``TileConfig()``) against tpugs' ``Trainer`` on its pure-JAX tiled engine,
at 64x48 with 120 Gaussians, ``feature_dim`` 8 -> 4, SH degree 1, the
depth loss and a linear teacher. The tolerances of ``test_torch_train.py``
(Adam amplifies tiny differences):

* loss (rtol 1e-4) and the gradients of every scene field and of both
  screen-gradient probes at one scene state: 3e-4 of max + 1e-8;
* three ``train_step``s: each step's losses within rtol 2e-3;
* ``render_eval`` of the trained scene (``rasterize_with_plan``): 2e-4
  absolute of tpugs' render of that same scene through its tiled path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.core.scene import GaussianScene as JGaussianScene
from tpugs.encoders import get_encoder as j_get_encoder
from tpugs.raster import api as ja
from tpugs.train.config import TrainConfig as JTrainConfig
from tpugs.train.trainer import Trainer as JTrainer
from tpugs.train.trainer import init_scene_from_points as j_init
from tpugs.utils.synthetic import orbit_cameras
from tpugs_torch.convert import FEATURE_FIELDS, SCENE_FIELDS, scene_to_numpy
from tpugs_torch.train.config import TrainConfig
from tpugs_torch.train.trainer import Trainer, init_scene_from_points

W, H, N, STEPS = 64, 48, 120, 3
KW = dict(max_steps=8, sh_degree=1, feature_dim=8, feature_out_dim=4, strategy="none",
          sh_degree_interval=100, random_bkgd=False, depth_loss=True, raster_engine="tiled")
FIELDS = SCENE_FIELDS + FEATURE_FIELDS


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    cams = orbit_cameras(STEPS, W, H, radius=2.5)
    teacher = j_get_encoder("linear:4")
    batches = []
    for c in range(STEPS):
        image = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        batches.append({
            "viewmat": np.array(cams.viewmats[c]), "K": np.array(cams.Ks[c]),
            "image": image, "image_id": c,
            "points": rng.uniform(0, [W, H], (50, 2)).astype(np.float32),
            "depths": rng.uniform(2.0, 3.0, (50,)).astype(np.float32),
            "feats": np.array(teacher(jnp.asarray(image))),
        })
    jt = JTrainer(JTrainConfig(**KW), j_init(pts, rgbs, JTrainConfig(**KW)), 1.0, width=W,
                  height=H, n_cameras=STEPS)
    pt = Trainer(TrainConfig(**KW), init_scene_from_points(pts, rgbs, TrainConfig(**KW),
                                                           device="cpu"),
                 1.0, width=W, height=H, n_cameras=STEPS, device="cpu")
    return jt, pt, batches


def _within(got, ref, what, frac=3e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= frac * scale + 1e-8, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


def test_engines_resolve_as_tpugs(setup):
    jt, pt, _ = setup
    assert jt.engine == pt.engine == "tiled"
    assert pt.tile_config.tile_size == jt.tile_config.tile_size == 16


def test_loss_and_gradients_match_tpugs(setup):
    jt, pt, batches = setup
    d = batches[0]
    pts, dep = d["points"], d["depths"]
    vm, Km = jnp.asarray(d["viewmat"]), jnp.asarray(d["K"])
    jt._estimate_sizes(vm[None], Km[None])

    def lf(s, probes):
        return jt._loss_fn(s, probes, {"pose": None, "app": None}, vm, Km,
                           jnp.asarray(d["image"]), jnp.asarray(d["feats"]), jnp.asarray(pts),
                           jnp.asarray(dep), jnp.ones(len(pts)), jnp.int32(0), jnp.zeros(3), 1,
                           jt._sizes)

    zeros = jnp.zeros((N, 2), jnp.float32)
    (l_ref, _), (g_ref, gp_ref) = jax.jit(jax.value_and_grad(lf, argnums=(0, 1), has_aux=True))(
        jt.scene, {"off": zeros, "abs": zeros})
    t = torch.tensor
    probes = {k: torch.zeros((N, 2), requires_grad=True) for k in ("off", "abs")}
    loss, _ = pt._loss_fn(pt.scene, probes, t(d["viewmat"]), t(d["K"]), t(d["image"]),
                          t(d["feats"]), t(pts), t(dep), torch.zeros(3), 1)
    leaves = [getattr(pt.scene, k) for k in FIELDS] + [probes["off"], probes["abs"]]
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-4)
    refs = [getattr(g_ref, k) for k in FIELDS] + [gp_ref["off"], gp_ref["abs"]]
    for name, g, r in zip(FIELDS + ("offset2d probe", "absgrad probe"), grads, refs):
        assert float(np.abs(np.asarray(r)).max()) > 0 or name == "quats", name
        _within(g.numpy(), r, f"gradient {name}")


def test_train_steps_and_eval_render_match_tpugs(setup):
    jt, pt, batches = setup
    for step, d in enumerate(batches):
        s_ref = jt.train_step(d, teacher_feats=jnp.asarray(d["feats"]))
        s = pt.train_step(d, teacher_feats=d["feats"])
        for k in ("loss", "l1", "ssim_loss", "feature_l1", "depth_l"):
            np.testing.assert_allclose(s[k], s_ref[k], rtol=2e-3, atol=2e-5,
                                       err_msg=f"step {step} {k}")
    assert pt.step == STEPS and np.isfinite(s["loss"])
    trained = JGaussianScene(**{k: jnp.asarray(v) for k, v in scene_to_numpy(pt.scene).items()})
    vm, Km = jnp.asarray(batches[0]["viewmat"]), jnp.asarray(batches[0]["K"])
    imgs_j, alphas_j, _ = ja.rasterize(trained.means, trained.quats, trained.scales,
                                       trained.opacities, trained.colors_all, vm, Km, W, H,
                                       sh_degree=trained.sh_degree)
    img, alpha = pt.render_eval(batches[0]["viewmat"], batches[0]["K"])
    assert img.shape == (H, W, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(imgs_j[0]), atol=2e-4)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alphas_j[0, ..., 0]), atol=2e-4)
