"""Densification strategies: the port's ``train/strategy.py`` (torch ops on
the CPU, the reference's numpy draws) against tpugs' on a seeded
300-Gaussian scene with features, with planted cases: 40 small and 40
large Gaussians of high screen gradient (duplicated and split), 30
transparent and 10 huge ones (pruned), a few high-gradient ones among the
pruned; and for MCMC 25 dead Gaussians.

* Default ``refine``: the same counts, the same rows in the same order
  (kept, duplicated, both split halves) bit for bit, except the split
  means, within 1e-6 (the offsets' rotation products); the same zero
  ``GradState``; the strategy's generator left in the same state.
* MCMC ``refine``: the same relocation targets (every row bit for bit) and
  counts; with no dead Gaussian, the scene untouched.
* ``reset_opacities`` bit for bit; ``pad_count`` and ``pad_to`` equal to
  tpugs', and ``project`` culls every padded row in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.core.scene import GaussianScene as JGaussianScene
from tpugs.core.scene import pad_count as j_pad_count
from tpugs.raster.projection import project as j_project
from tpugs.train import strategy as js
from tpugs.train.config import TrainConfig as JTrainConfig
from tpugs.utils.synthetic import orbit_cameras
from tpugs_torch.convert import FEATURE_FIELDS, SCENE_FIELDS, scene_from_numpy, scene_to_numpy
from tpugs_torch.core.scene import pad_count
from tpugs_torch.raster.projection import project
from tpugs_torch.train import strategy as ts
from tpugs_torch.train.config import TrainConfig

N = 300
FIELDS = SCENE_FIELDS + FEATURE_FIELDS
KW = dict(grow_grad2d=2e-4, grow_scale3d=0.01, prune_opa=0.005, prune_scale3d=0.1)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    log_scales = np.log(rng.uniform(0.002, 0.06, (N, 3)))
    log_scales[:40] = np.log(rng.uniform(0.001, 0.008, (40, 3)))  # small: duplicate
    log_scales[40:80] = np.log(rng.uniform(0.02, 0.06, (40, 3)))  # large: split
    log_scales[80:90, 0] = np.log(0.3)  # huge: pruned
    logit = rng.uniform(-2, 3, N)
    logit[90:120] = -8.0  # transparent: pruned
    grad = rng.uniform(0, 1e-4, N)
    grad[:80] = rng.uniform(5e-4, 1e-3, 80)  # high gradient
    grad[85:95] = 1e-3  # high gradient among the pruned
    a = {
        "means": rng.uniform(-1, 1, (N, 3)), "quats": rng.normal(size=(N, 4)),
        "log_scales": log_scales, "logit_opacities": logit,
        "sh0": rng.normal(size=(N, 1, 3)), "shN": rng.normal(size=(N, 3, 3)),
        "features": rng.normal(size=(N, 8)), "feature_proj": rng.normal(size=(8, 4)),
    }
    a = {k: v.astype(np.float32) for k, v in a.items()}
    count = rng.integers(1, 6, N).astype(np.float32)
    return a, (grad * count).astype(np.float32), count


def _jscene(a):
    return JGaussianScene(**{k: jnp.asarray(v) for k, v in a.items()})


def _np(scene):
    return scene_to_numpy(scene) if hasattr(scene.means, "numpy") else {
        k: np.asarray(getattr(scene, k)) for k in FIELDS if getattr(scene, k) is not None}


@pytest.mark.parametrize("seed", [0, 1])
def test_default_refine_matches_tpugs(seed):
    a, gsum, count = _arrays(seed)
    ref_strat = js.DefaultStrategy(JTrainConfig(**KW), 1.0, seed=5)
    ours_strat = ts.DefaultStrategy(TrainConfig(**KW), 1.0, seed=5)
    ref, ref_state, ref_info = ref_strat.refine(_jscene(a), js.GradState(gsum.copy(), count))
    new, state, info = ours_strat.refine(scene_from_numpy(a, device="cpu"), ts.GradState(
        torch.from_numpy(gsum.copy()), torch.from_numpy(count)))
    assert info == ref_info
    assert info["duplicated"] >= 30 and info["split"] >= 30 and info["pruned"] >= 40
    got, want = _np(new), _np(ref)
    n_split = 2 * info["split"]
    for k in FIELDS:
        if k == "means":
            np.testing.assert_array_equal(got[k][:-n_split], want[k][:-n_split])
            np.testing.assert_allclose(got[k][-n_split:], want[k][-n_split:], rtol=0, atol=1e-6)
            assert not np.array_equal(got[k][-n_split:-n_split // 2],
                                      got[k][-n_split // 2:]), "the halves moved apart"
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch.equal(state.grad2d_sum, torch.zeros(new.num_gaussians))
    assert torch.equal(state.count, torch.zeros(new.num_gaussians))
    assert ours_strat.rng.bit_generator.state == ref_strat.rng.bit_generator.state


def test_mcmc_refine_matches_tpugs():
    a, gsum, count = _arrays(2)
    a["logit_opacities"][90:120] = 1.0
    a["logit_opacities"][:25] = -7.0  # dead: opacity under prune_opa
    ref_strat = js.MCMCStrategy(JTrainConfig(**KW), 1.0, seed=3)
    ours_strat = ts.MCMCStrategy(TrainConfig(**KW), 1.0, seed=3)
    ref, _, ref_info = ref_strat.refine(_jscene(a), js.GradState(gsum, count))
    new, state, info = ours_strat.refine(scene_from_numpy(a, device="cpu"),
                                         ts.GradState.zeros(N))
    assert info == ref_info and info["relocated"] == 25 and new.num_gaussians == N
    got, want = _np(new), _np(ref)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not np.array_equal(got["means"][:25], a["means"][:25])
    np.testing.assert_array_equal(got["means"][25:], a["means"][25:])
    assert torch.equal(state.count, torch.zeros(N))
    # nothing dead: the scene is returned as it is
    a["logit_opacities"][:25] = 1.0
    scene = scene_from_numpy(a, device="cpu")
    again, _, info = ours_strat.refine(scene, ts.GradState.zeros(N))
    assert info == {"relocated": 0, "num_gaussians": N} and again is scene


def test_reset_opacities_matches_tpugs():
    a, _, _ = _arrays(3)
    ref = js.DefaultStrategy(JTrainConfig(**KW)).reset_opacities(_jscene(a))
    got = ts.DefaultStrategy(TrainConfig(**KW)).reset_opacities(scene_from_numpy(a, "cpu"))
    np.testing.assert_array_equal(got.logit_opacities.numpy(), np.asarray(ref.logit_opacities))
    assert float(got.logit_opacities.max()) <= float(np.log(0.01 / 0.99)) + 1e-7
    mc = ts.MCMCStrategy(TrainConfig(**KW))
    scene = scene_from_numpy(a, "cpu")
    assert mc.reset_opacities(scene) is scene


def test_make_strategy():
    assert isinstance(ts.make_strategy(TrainConfig(), 1.0), ts.DefaultStrategy)
    assert isinstance(ts.make_strategy(TrainConfig(strategy="mcmc"), 1.0), ts.MCMCStrategy)
    assert ts.make_strategy(TrainConfig(strategy="none"), 1.0) is None
    with pytest.raises(ValueError):
        ts.make_strategy(TrainConfig(strategy="adc"), 1.0)


@pytest.mark.parametrize("n,multiple", [(1, 256), (256, 256), (257, 256), (300, 64),
                                        (524288, 16384), (524289, 16384)])
def test_pad_count_matches_tpugs(n, multiple):
    assert pad_count(n, multiple) == j_pad_count(n, multiple)


def test_padded_rows_match_tpugs_and_project_culls_them():
    a, _, _ = _arrays(4)
    cap = pad_count(N, 64)
    got = _np(scene_from_numpy(a, "cpu").pad_to(cap))
    want = _np(_jscene(a).pad_to(cap))
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cams = orbit_cameras(2, 64, 48, radius=2.5)
    for c in range(2):
        vm, K = np.asarray(cams.viewmats[c]), np.asarray(cams.Ks[c])
        s = scene_from_numpy(got, "cpu")
        proj = project(s.means, s.quats, s.scales, s.opacities, torch.tensor(vm),
                       torch.tensor(K), 64, 48)
        js_ = _jscene(want)
        jproj = j_project(js_.means, js_.quats, js_.scales, js_.opacities, jnp.asarray(vm),
                          jnp.asarray(K), 64, 48)
        assert not proj.valid[N:].any() and not np.asarray(jproj.valid)[N:].any()
        assert proj.valid[:N].any()
