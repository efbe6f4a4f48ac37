"""The port's ``Trainer`` (``device="cpu"``) against tpugs' across refines
and an opacity reset: 64x48, 120 Gaussians, strategy "default" with
``refine_every`` 2 (refines at steps 2 and 4), ``reset_every`` 4,
``capacity_multiple`` 64, tpugs on its Pallas engine in interpret mode at
``pallas_trans_eps`` 0, five ``train_step``s, with ``absgrad`` off and on.

* each step's loss within rtol 2e-3 (the train tests' tolerance);
* N equal after each refine, a multiple of 64, the refine's info equal;
* the means' learning rate of every step equal to optax's schedule at
  tpugs' count since its last optimizer init, which a refine restarts
  (rtol 1e-6); the count itself equal;
* after the reset, the opacities' Adam state empty in the port (a fresh
  optax init in tpugs) and every logit at most logit(0.01).

The two packages' parameters part by float rounding, which Adam's first
steps after each refine amplify (a step of lr * sign(g) where g is noise):
after two refines, one Gaussian's mean screen gradient differed by 3%.
So the cases keep every refine's decisions away from their thresholds: in
tpugs' state, each live Gaussian's mean screen gradient, largest scale and
opacity differ from ``grow_grad2d``, ``grow_scale3d``, ``prune_scale3d``
and ``prune_opa`` by more than 1% of the threshold. The signed case
duplicates, splits and prunes; the absgrad case splits and prunes.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tpugs.train.config import TrainConfig as JTrainConfig
from tpugs.train.trainer import Trainer as JTrainer
from tpugs.train.trainer import init_scene_from_points as j_init
from tpugs.utils.synthetic import orbit_cameras
from tpugs_torch.train.config import TrainConfig
from tpugs_torch.train.trainer import Trainer, init_scene_from_points

W, H, N, STEPS = 64, 48, 120, 5
KW = dict(max_steps=8, sh_degree=1, feature_dim=0, strategy="default", sh_degree_interval=100,
          random_bkgd=False, pallas_trans_eps=0.0, refine_start_iter=2, refine_every=2,
          refine_stop_iter=7, reset_every=4, capacity_multiple=64)
# Per absgrad, the thresholds and initial scale (kNN distance times
# init_scale): the decisions of every refine keep their margin (below).
CASES = {
    "signed": dict(absgrad=False, grow_grad2d=4.64e-4, grow_scale3d=0.02, init_scale=0.15),
    "absgrad": dict(absgrad=True, grow_grad2d=1e-3, grow_scale3d=0.01, init_scale=0.2),
}
MARGIN = 1e-2


def _means_count(jt) -> int:
    """tpugs' means schedule count: updates since its optimizer's init."""
    return int(jt.opt_state.inner_states["means"].inner_state[1].count)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_refines_and_resets_as_tpugs(case):
    kw = {**KW, **CASES[case]}
    grow, small = kw["grow_grad2d"], kw["grow_scale3d"]
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    cams = orbit_cameras(4, W, H, radius=2.5)
    images = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in range(4)]
    jt = JTrainer(JTrainConfig(raster_engine="pallas", **kw), j_init(pts, rgbs, JTrainConfig(**kw)),
                  1.0, width=W, height=H, n_cameras=4)
    pt = Trainer(TrainConfig(**kw), init_scene_from_points(pts, rgbs, TrainConfig(**kw),
                                                           device="cpu"),
                 1.0, width=W, height=H, n_cameras=4, device="cpu")
    refines, ref_infos, margins = [], [], []
    ref_refine, our_refine = jt.strategy.refine, pt.refine

    def spy_ref(scene, state):
        avg = state.grad2d_sum / np.maximum(state.count, 1.0)
        scales = np.exp(np.asarray(scene.log_scales)).max(axis=1)
        opac = 1.0 / (1.0 + np.exp(-np.asarray(scene.logit_opacities)))
        live = opac > 1e-9  # padded rows
        margins.append(min(float(np.min(np.abs(avg[live] / grow - 1.0))),
                           float(np.min(np.abs(scales[live] / small - 1.0))),
                           float(np.min(np.abs(scales[live] / 0.1 - 1.0))),
                           float(np.min(np.abs(opac[live] / 0.005 - 1.0)))))
        out = ref_refine(scene, state)
        ref_infos.append(out[2])
        return out

    def spy_ours():
        info = our_refine()
        refines.append(info)
        return info

    jt.strategy.refine, pt.refine = spy_ref, spy_ours
    sched = optax.exponential_decay(init_value=TrainConfig().means_lr,
                                    transition_steps=KW["max_steps"], decay_rate=0.01)
    for s in range(STEPS):
        c = s % 4
        batch = {"viewmat": np.array(cams.viewmats[c]), "K": np.array(cams.Ks[c]),
                 "image": images[c], "image_id": c}
        k = _means_count(jt)
        assert pt.means_step_count() == k, f"step {s}"
        n_refines = len(refines)
        ref = jt.train_step(batch)
        got = pt.train_step(batch)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-3, err_msg=f"step {s}")
        assert pt.scene.num_gaussians == jt.scene.num_gaussians, f"step {s}"
        if len(refines) == n_refines:  # no refine: the lr this step used stays set
            lr = next(g["lr"] for g in pt.optimizer.param_groups if g["name"] == "means")
            np.testing.assert_allclose(lr, float(sched(k)), rtol=1e-6, err_msg=f"step {s}")
        else:
            assert _means_count(jt) == 0 and pt.means_step_count() == 0
            assert pt.scene.num_gaussians % 64 == 0
            assert refines[-1]["alive"] <= pt.scene.num_gaussians < refines[-1]["alive"] + 64
        if s == 4:  # the reset: a fresh opacities state, every opacity <= 0.01
            group = next(g for g in pt.optimizer.param_groups if g["name"] == "opacities")
            assert not pt.optimizer.state.get(group["params"][0])
            assert float(pt.scene.logit_opacities.detach().max()) <= float(np.log(0.01 / 0.99)) + 1e-7
            assert float(jnp.max(jt.scene.logit_opacities)) <= float(np.log(0.01 / 0.99)) + 1e-7
    assert len(refines) == 2 and pt.step == STEPS
    assert min(margins) > MARGIN, margins
    assert all(sum(r[k] for r in refines) > 0 for k in ("split", "pruned"))
    assert sum(r["duplicated"] for r in refines) > 0 or kw["absgrad"]
    assert refines == ref_infos  # tpugs' refine adds "alive" to the strategy's info too
