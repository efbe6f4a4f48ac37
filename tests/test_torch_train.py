"""The training slice as a whole: the port's ``Trainer`` (``device="cpu"``,
the kernels' plain twins) against tpugs' ``Trainer`` on the Pallas engine
(interpret mode), at 64x48 with 120 Gaussians, ``feature_dim`` 8 -> 4, SH
degree 1, the depth loss and a linear teacher; ``pallas_trans_eps`` 0, so
both composite every block (Adam amplifies tiny differences).

* ``init_scene_from_points``: the same scene bit for bit (same draws);
* the means learning rate: optax's ``exponential_decay`` to 1e-6;
* loss (rtol 1e-4) and the gradients of every scene field and of both
  screen-gradient probes at one scene state: 3e-4 of max + 1e-8, as
  ``tests/test_train_pallas.py`` holds the engines;
* three ``train_step``s: each step's losses within rtol 2e-3;
* ``render_eval`` of the trained scene: 2e-4 absolute of tpugs' render of
  that same scene (``render_scene_pallas``), the reference test's limit;
* ``psnr``, ``ssim`` and ``ssim_loss``: 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpugs.core.scene import GaussianScene as JGaussianScene
from tpugs.encoders import get_encoder as j_get_encoder
from tpugs.raster.pallas_train import render_scene_pallas
from tpugs.train import metrics as jm
from tpugs.train.config import TrainConfig as JTrainConfig
from tpugs.train.trainer import Trainer as JTrainer
from tpugs.train.trainer import init_scene_from_points as j_init
from tpugs.utils.synthetic import orbit_cameras
from tpugs_torch.convert import FEATURE_FIELDS, SCENE_FIELDS, scene_to_numpy
from tpugs_torch.train import metrics as tm
from tpugs_torch.train.config import TrainConfig
from tpugs_torch.raster.train import grad_row_width
from tpugs_torch.train.trainer import STAGES, Trainer, init_scene_from_points, means_lr

W, H, N, STEPS = 64, 48, 120, 3
KW = dict(max_steps=8, sh_degree=1, feature_dim=8, feature_out_dim=4, strategy="none",
          sh_degree_interval=100, random_bkgd=False, depth_loss=True, pallas_trans_eps=0.0)
FIELDS = SCENE_FIELDS + FEATURE_FIELDS


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
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
    jt = JTrainer(JTrainConfig(raster_engine="pallas", **KW), j_init(pts, rgbs, JTrainConfig(**KW)),
                  1.0, width=W, height=H, n_cameras=STEPS)
    pt = Trainer(TrainConfig(**KW), init_scene_from_points(pts, rgbs, TrainConfig(**KW),
                                                           device="cpu"),
                 1.0, width=W, height=H, n_cameras=STEPS, device="cpu")
    return jt, pt, batches, (pts, rgbs)


def _within(got, ref, what, frac=3e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= frac * scale + 1e-8, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


def test_init_scene_bit_identical(setup):
    jt, pt, _, (pts, rgbs) = setup
    cfg = TrainConfig(**KW)
    ours = scene_to_numpy(init_scene_from_points(pts, rgbs, cfg, device="cpu"))
    ref = j_init(pts, rgbs, JTrainConfig(**KW))
    assert set(ours) == set(FIELDS)
    for k in FIELDS:
        np.testing.assert_array_equal(ours[k], np.asarray(getattr(ref, k)), err_msg=k)


def test_means_lr_matches_optax():
    cfg = TrainConfig(max_steps=300)
    sched = optax.exponential_decay(init_value=cfg.means_lr * 2.0 * np.sqrt(4),
                                    transition_steps=cfg.max_steps, decay_rate=0.01)
    for k in (0, 1, 17, 150, 299):
        np.testing.assert_allclose(means_lr(cfg, 2.0, 4, k), float(sched(k)), rtol=1e-6)


def test_loss_and_gradients_match_tpugs(setup):
    """Same scene state, full loss (rgb + ssim + depth + features)."""
    jt, pt, batches, _ = setup
    import jax

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
    (l_ref, _), (g_ref, gp_ref) = jax.value_and_grad(lf, argnums=(0, 1), has_aux=True)(
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
    jt, pt, batches, _ = setup
    for step, d in enumerate(batches):
        s_ref = jt.train_step(d, teacher_feats=jnp.asarray(d["feats"]))
        s = pt.train_step(d, teacher_feats=d["feats"])
        for k in ("loss", "l1", "ssim_loss", "feature_l1", "depth_l"):
            np.testing.assert_allclose(s[k], s_ref[k], rtol=2e-3, atol=2e-5,
                                       err_msg=f"step {step} {k}")
    assert pt.step == STEPS and np.isfinite(s["loss"])
    # the eval render of the port's trained scene, through each package
    trained = JGaussianScene(**{k: jnp.asarray(v) for k, v in scene_to_numpy(pt.scene).items()})
    vm, Km = batches[0]["viewmat"], batches[0]["K"]
    img_j, alpha_j = render_scene_pallas(trained, jnp.asarray(vm), jnp.asarray(Km), W, H,
                                         tile_size=pt.tile_size, interpret=True)
    img, alpha = pt.render_eval(vm, Km)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=2e-4)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j), atol=2e-4)


def test_train_chunk_runs_steps_and_updates_every_parameter(setup):
    """Two steps, the second at SH degree 1, so that shN moves too."""
    _, _, batches, (pts, rgbs) = setup
    cfg = TrainConfig(**{**KW, "sh_degree_interval": 1})
    t = Trainer(cfg, init_scene_from_points(pts, rgbs, cfg, device="cpu"), 1.0,
                teacher=lambda img: img @ torch.ones((3, 4)), width=W, height=H,
                device="cpu")
    before = {k: getattr(t.scene, k).detach().clone() for k in FIELDS}
    staged = {k: np.stack([b[src] for b in batches]) for k, src in (
        ("images", "image"), ("viewmats", "viewmat"), ("Ks", "K"), ("points", "points"),
        ("point_depths", "depths"))}
    staged["point_masks"] = np.ones(staged["point_depths"].shape, np.float32)
    staged["point_masks"][:, 40:] = 0.0  # padding slots, as tpugs stages them
    out = t.train_chunk(staged, 2, cam_idx=[0, 1])
    assert out["loss"].shape == (2,) and np.isfinite(out["loss"]).all()
    assert (out["depth_l"] > 0).all()
    assert t.step == 2
    for k in FIELDS:
        assert not torch.equal(getattr(t.scene, k), before[k]), k


def test_stage_marks_and_record_leave_the_step_unchanged(setup):
    """With ``on_stage`` and ``record`` set, one step reports every stage in
    order and records the render's kernel inputs and rows, and gives the
    same losses and parameters as without them."""
    _, _, batches, (pts, rgbs) = setup
    staged = {k: np.stack([b[src] for b in batches])
              for k, src in (("images", "image"), ("viewmats", "viewmat"), ("Ks", "K"))}
    cfg = TrainConfig(**KW)

    def trainer():
        return Trainer(cfg, init_scene_from_points(pts, rgbs, cfg, device="cpu"), 1.0,
                       teacher=lambda img: img @ torch.ones((3, 4)), width=W, height=H,
                       device="cpu")

    plain, watched = trainer(), trainer()
    marks = []
    watched.on_stage, watched.record = marks.append, {}
    ref = plain.train_chunk(staged, 1, cam_idx=[1])
    out = watched.train_chunk(staged, 1, cam_idx=[1])
    assert tuple(marks) == STAGES
    rec = watched.record
    d = 3 + 1 + KW["feature_dim"]  # colour, depth, features
    assert rec["cols"].shape == (rec["plan"].T_padded, d)
    assert rec["rows"].shape == (rec["plan"].T_padded, grad_row_width(d))
    assert rec["g_image"].shape == rec["image"].shape == (H, W, d)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for k in FIELDS:
        assert torch.equal(getattr(watched.scene, k), getattr(plain.scene, k)), k


@pytest.mark.parametrize("fn", ["psnr", "ssim", "ssim_loss"])
def test_metrics_match_tpugs(fn):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ref = float(getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tm, fn)(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
