"""The eager lift and gradient pruning against tpugs (JAX on the CPU, its
pure-JAX tiled path), f32, on numpy-seeded scenes of 150 Gaussians (plus
10 planted far away) at 64x48, 3 orbit views, the linear encoder at D = 8.

* ``accumulate_view`` with and without features, ``compute_visibility_weights``
  and ``create_feature_field_batch``'s and ``create_feature_field``'s sums:
  1e-4 of the reference's max;
* the normalised fields (``create_feature_field``,
  ``create_feature_field_batch`` with ``cam_weights``): 1e-6 absolute where
  the weight is not vanishing (over 1e-3 of its max), rows without weight
  zero in both;
* tpugs' occlusion case (``tests/test_lift.py``): the wall's weight over
  100, the hidden Gaussian's under 1e-2 and 1e-4 of the wall's;
* ``prune_by_gradients``: the same mask as tpugs'; then
  ``verify_pruning_equivalence`` passes with tpugs' max pixel error to
  1e-6;
* ``estimate_sizes``: tpugs' buckets; ``select``/``replace`` of the
  scene: exact;
* partial edge tiles (72x44 at tile 16, 2 views): ``accumulate_view``,
  ``compute_visibility_weights`` and ``create_feature_field`` as above
  (their weights count every pixel of an edge tile, as tpugs' do);
  ``create_feature_field_batch``'s field 1e-6 where lit, and its weight
  sums (pixels inside W x H only) 1e-4 of max against tpugs'
  ``accumulate_view`` of an all-ones feature image, which sums the same
  pixels; tpugs' own weight sums exceed them where a Gaussian reaches
  past the image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.core.camera import Camera as JCamera
from tpugs.core.camera import intrinsics_matrix
from tpugs.core.scene import GaussianScene as JScene
from tpugs.encoders.base import LinearRGBEncoder as JLinear
from tpugs.lift import backproject as jbp
from tpugs.lift import batch as jbatch
from tpugs.lift import ops as jops
from tpugs.lift import prune as jprune
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import (
    SCENE_FIELDS,
    cameras_from_numpy,
    linear_encoder_from_numpy,
    scene_from_numpy,
)
from tpugs_torch.core.camera import Camera
from tpugs_torch.lift import backproject as tbp
from tpugs_torch.lift import batch as tbatch
from tpugs_torch.lift import ops as tops
from tpugs_torch.lift import prune as tprune

W, H, D, VIEWS = 64, 48, 8, 3
EW, EH = 72, 44  # not multiples of the tile: partial edge tiles


def _planted(js):
    """As tpugs' ``test_prune_then_render_equivalence``: 10 opaque
    Gaussians far outside every frustum (high above the orbit)."""
    k = 10
    return js.replace(
        means=jnp.concatenate([js.means, jnp.tile(jnp.array([[0.0, 100.0, 0.0]]), (k, 1))]),
        quats=jnp.concatenate([js.quats, jnp.tile(jnp.array([[1.0, 0, 0, 0]]), (k, 1))]),
        log_scales=jnp.concatenate([js.log_scales, jnp.full((k, 3), -3.0)]),
        logit_opacities=jnp.concatenate([js.logit_opacities, jnp.full((k,), 2.0)]),
        sh0=jnp.concatenate([js.sh0, jnp.ones((k, 1, 3))]),
        shN=jnp.concatenate([js.shN, jnp.zeros((k,) + js.shN.shape[1:])]),
    )


def _port_scene(js):
    return scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                            device="cpu")


@pytest.fixture(scope="module")
def setup():
    js = _planted(random_scene(150, seed=2, extent=0.8, scale_range=(0.02, 0.1)))
    jc = orbit_cameras(VIEWS, W, H, radius=2.5)
    jenc = JLinear(D, seed=1)
    tc = cameras_from_numpy(np.array(jc.viewmats), np.array(jc.Ks), W, H, device="cpu")
    tenc = linear_encoder_from_numpy(np.array(jenc._proj), device="cpu")
    return js, jc, jenc, _port_scene(js), tc, tenc


@pytest.fixture(scope="module")
def edge(setup):
    js, _, jenc, ts, _, tenc = setup
    jc = orbit_cameras(2, EW, EH, radius=2.5)
    tc = cameras_from_numpy(np.array(jc.viewmats), np.array(jc.Ks), EW, EH, device="cpu")
    return js, jc, jenc, ts, tc, tenc


def _within(got, ref, frac, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    err = float(np.abs(got - ref).max())
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("with_feats", [False, True])
def test_accumulate_view_matches_tpugs(setup, with_feats):
    js, jc, _, ts, tc, _ = setup
    feats = np.random.default_rng(3).normal(size=(H, W, 5)).astype(np.float32)
    f_j, w_j = jops.accumulate_view(js, jc.viewmats[1], jc.Ks[1], W, H,
                                    feat_image=jnp.asarray(feats) if with_feats else None)
    f, w = tops.accumulate_view(ts, tc.viewmats[1], tc.Ks[1], W, H,
                                feat_image=torch.from_numpy(feats) if with_feats else None,
                                device="cpu")
    _within(w.numpy(), w_j, 1e-4, "weight sums")
    if with_feats:
        _within(f.numpy(), f_j, 1e-4, "feature sums")
    else:
        assert f is None and f_j is None
    assert float(w.sum()) <= W * H


def test_create_feature_field_matches_tpugs(setup):
    js, jc, jenc, ts, tc, tenc = setup
    ref = np.asarray(jbp.create_feature_field(js, jc, jenc, verbose=False))
    field = tbp.create_feature_field(ts, tc, tenc, verbose=False, device="cpu").numpy()
    w = tprune.compute_visibility_weights(ts, tc, device="cpu").numpy()
    lit = w > 1e-3 * w.max()
    assert lit.mean() > 0.3
    np.testing.assert_allclose(field[lit], ref[lit], atol=1e-6)
    np.testing.assert_array_equal(field[w == 0], 0.0)
    # the view's sums themselves
    fs_j, ws_j = jbp.backproject_view(js, jc.viewmats[0], jc.Ks[0], W, H, jenc)
    fs, ws = tbp.backproject_view(ts, tc.viewmats[0], tc.Ks[0], W, H, tenc, device="cpu")
    _within(fs.numpy(), fs_j, 1e-4, "feature sums")
    _within(ws.numpy(), ws_j, 1e-4, "weight sums")


def test_create_feature_field_batch_with_cam_weights(setup):
    js, jc, jenc, ts, tc, tenc = setup
    sizes_j = jbatch.estimate_sizes(js, jc)
    sizes = tbatch.estimate_sizes(ts, tc, device="cpu")
    assert tuple(sizes) == tuple(sizes_j)
    cw = np.array([1.0, 0.0, 1.0], np.float32)
    ref = np.asarray(jbatch.create_feature_field_batch(
        js, jc.viewmats, jc.Ks, W, H, jenc, sizes_j, cam_weights=jnp.asarray(cw)))
    field = tbatch.create_feature_field_batch(ts, tc.viewmats, tc.Ks, W, H, tenc, sizes,
                                              cam_weights=torch.from_numpy(cw),
                                              device="cpu").numpy()
    num_j, den_j = jbatch.backproject_views(js, jc.viewmats, jc.Ks, W, H, jenc, sizes_j,
                                            cam_weights=jnp.asarray(cw))
    num, den = tbatch.backproject_views(ts, tc.viewmats, tc.Ks, W, H, tenc, tile_size=16,
                                        contrib_dtype=torch.float32, trans_eps=0.0,
                                        device="cpu", cam_weights=torch.from_numpy(cw))
    _within(den.numpy(), den_j, 1e-4, "den")
    _within(num.numpy(), num_j, 1e-4, "num")
    den_j = np.asarray(den_j)
    lit = den_j > 1e-3 * den_j.max()
    np.testing.assert_allclose(field[lit], ref[lit], atol=1e-6)
    np.testing.assert_array_equal(field[den.numpy() == 0], 0.0)
    # view 1 is weighted out: the field equals that of views 0 and 2 alone
    two = Camera(tc.viewmats[[0, 2]], tc.Ks[[0, 2]], W, H)
    alone = tbatch.create_feature_field_batch(ts, two.viewmats, two.Ks, W, H, tenc,
                                              device="cpu").numpy()
    np.testing.assert_allclose(field, alone, atol=1e-6)


def test_visibility_weights_detect_occlusion():
    means = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 3.0]], np.float32)
    arrays = dict(means=means, quats=np.tile([[1.0, 0, 0, 0]], (2, 1)),
                  log_scales=np.log([[1.0, 1.0, 0.01], [0.01, 0.01, 0.01]]),
                  logit_opacities=np.array([12.0, 2.0]), sh0=np.full((2, 1, 3), 0.5),
                  shN=np.zeros((2, 15, 3)))
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    K = intrinsics_matrix(60.0, 60.0, W / 2, H / 2)
    jc = JCamera(jnp.eye(4)[None], jnp.asarray(K)[None], W, H)
    ref = np.asarray(jprune.compute_visibility_weights(
        JScene(**{k: jnp.asarray(v) for k, v in arrays.items()}), jc))
    tc = Camera(torch.eye(4)[None], _t(K)[None], W, H)
    w = tprune.compute_visibility_weights(scene_from_numpy(arrays, device="cpu"), tc,
                                          device="cpu").numpy()
    assert w[0] > 100 and w[1] < 1e-2 and w[1] < w[0] * 1e-4
    _within(w, ref, 1e-4, "weights")


def test_prune_mask_and_equivalence_match_tpugs(setup):
    js, jc, _, ts, tc, _ = setup
    w_j = np.asarray(jprune.compute_visibility_weights(js, jc))
    w = tprune.compute_visibility_weights(ts, tc, device="cpu").numpy()
    _within(w, w_j, 1e-4, "visibility weights")
    pruned_j = jprune.prune_by_gradients(js, jc, verbose=False)
    pruned = tprune.prune_by_gradients(ts, tc, verbose=False, device="cpu")
    np.testing.assert_array_equal(w > 0, w_j > 0)
    assert pruned.num_gaussians == pruned_j.num_gaussians < ts.num_gaussians - 9
    for k in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(pruned, k).numpy(),
                                      np.asarray(getattr(pruned_j, k)), err_msg=k)
    err_j, total_j = jprune.verify_pruning_equivalence(js, pruned_j, jc, verbose=False)
    err, total = tprune.verify_pruning_equivalence(ts, pruned, tc, verbose=False,
                                                   device="cpu")
    assert err < 1 / 510
    np.testing.assert_allclose(err, err_j, atol=1e-6)
    np.testing.assert_allclose(total, total_j, atol=1e-6 * W * H * 3 * VIEWS)
    assert tprune.test_proper_pruning is tprune.verify_pruning_equivalence
    assert tprune.test_proper_pruning.__test__ is False


def test_verify_pruning_equivalence_catches_a_visible_change(setup):
    _, _, _, ts, tc, _ = setup
    with pytest.raises(AssertionError, match="1/\\(255\\*2\\)"):
        tprune.verify_pruning_equivalence(ts, ts.select(torch.arange(0, 150, 2)), tc,
                                          verbose=False, device="cpu")


def test_select_and_replace(setup):
    js, _, _, ts, _, _ = setup
    mask = np.random.default_rng(5).uniform(size=ts.num_gaussians) > 0.4
    idx = np.nonzero(mask)[0]
    for how in (torch.from_numpy(mask), torch.from_numpy(idx), mask):
        got = ts.select(how)
        ref = js.select(mask)
        for k in SCENE_FIELDS:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(ref, k)), err_msg=k)
    moved = ts.replace(means=ts.means + 1.0)
    assert torch.equal(moved.means, ts.means + 1.0) and moved.quats is ts.quats
    feat = ts.replace(features=torch.ones((ts.num_gaussians, 4)),
                      feature_proj=torch.ones((4, 2)))
    sel = feat.select(torch.from_numpy(idx))
    assert sel.features.shape == (len(idx), 4) and sel.feature_proj is feat.feature_proj


def test_edge_tiles_accumulate_and_visibility_match_tpugs(edge):
    js, jc, _, ts, tc, _ = edge
    feats = np.random.default_rng(4).normal(size=(EH, EW, 5)).astype(np.float32)
    f_j, w_j = jops.accumulate_view(js, jc.viewmats[0], jc.Ks[0], EW, EH,
                                    feat_image=jnp.asarray(feats))
    f, w = tops.accumulate_view(ts, tc.viewmats[0], tc.Ks[0], EW, EH,
                                feat_image=torch.from_numpy(feats), device="cpu")
    _within(w.numpy(), w_j, 1e-4, "weight sums")
    _within(f.numpy(), f_j, 1e-4, "feature sums")
    v_j = np.asarray(jprune.compute_visibility_weights(js, jc))
    v = tprune.compute_visibility_weights(ts, tc, device="cpu").numpy()
    _within(v, v_j, 1e-4, "visibility weights")
    np.testing.assert_array_equal(v > 0, v_j > 0)


def test_edge_tiles_create_feature_field_matches_tpugs(edge):
    js, jc, jenc, ts, tc, tenc = edge
    ref = np.asarray(jbp.create_feature_field(js, jc, jenc, verbose=False))
    field = tbp.create_feature_field(ts, tc, tenc, verbose=False, device="cpu").numpy()
    w = tprune.compute_visibility_weights(ts, tc, device="cpu").numpy()
    lit = w > 1e-3 * w.max()
    assert lit.mean() > 0.3
    np.testing.assert_allclose(field[lit], ref[lit], atol=1e-6)
    np.testing.assert_array_equal(field[w == 0], 0.0)


def test_edge_tiles_batch_weight_sums_count_the_image_only(edge):
    js, jc, jenc, ts, tc, tenc = edge
    cw = np.array([1.0, 0.5], np.float32)
    sizes_j = jbatch.estimate_sizes(js, jc)
    ref = np.asarray(jbatch.create_feature_field_batch(
        js, jc.viewmats, jc.Ks, EW, EH, jenc, sizes_j, cam_weights=jnp.asarray(cw)))
    field = tbatch.create_feature_field_batch(ts, tc.viewmats, tc.Ks, EW, EH, tenc,
                                              cam_weights=torch.from_numpy(cw),
                                              device="cpu").numpy()
    _, den = tbatch.backproject_views(ts, tc.viewmats, tc.Ks, EW, EH, tenc, tile_size=16,
                                      contrib_dtype=torch.float32, trans_eps=0.0,
                                      device="cpu", cam_weights=torch.from_numpy(cw))
    _, den_j = jbatch.backproject_views(js, jc.viewmats, jc.Ks, EW, EH, jenc, sizes_j,
                                        cam_weights=jnp.asarray(cw))
    den, den_j = den.numpy(), np.asarray(den_j)
    ones = jnp.ones((EH, EW, 1))
    inside = sum(c * np.asarray(jops.accumulate_view(js, jc.viewmats[i], jc.Ks[i], EW, EH,
                                                     feat_image=ones)[0][:, 0])
                 for i, c in enumerate(cw))
    _within(den, inside, 1e-4, "weight sums inside W x H")
    assert float((den_j - den).max()) > 1e-3 * float(den_j.max())
    assert float((den_j - den).min()) >= -1e-4 * float(den_j.max())
    lit = den_j > 1e-3 * den_j.max()
    np.testing.assert_allclose(field[lit], ref[lit], atol=1e-6)
    np.testing.assert_array_equal(field[den == 0], 0.0)
