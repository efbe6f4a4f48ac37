"""The port's visualisation (``tpugs_torch.viz``: common, gif, pca) against
tpugs' (JAX on the CPU, its pure-JAX tiled rasterizer), on tpugs' viz
scene (80 Gaussians, 2 orbit views at 48x32) and a seeded 6-d field of
unit rows, handed to both packages.

* ``create_checkerboard`` equal; ``to_uint8`` equal (it truncates);
  ``overlay_mask_red`` equal;
* ``render_to_gif`` frames (plain, checkerboard, ``no_sh``) and
  ``render_mask_2d_to_gif`` frames within 1 uint8 unit of tpugs' (the
  renders agree to 2e-5; a truncation can fall either side), their
  masks equal where the per-pixel margin exceeds 1e-4; the GIF and the
  per-frame PNGs are written where a path is given (files are
  palette-quantised, so frames are compared, not files);
* ``feature_pca``: the mean to 1e-9, the components equal to tpugs' up to
  sign, to 1e-6; ``pca_colors`` 1e-6 with shared and fresh percentiles;
* ``render_pca`` in both modes within 1 uint8 unit; an unknown mode
  raises ValueError.
"""

import os

import numpy as np
import pytest
import torch

from tpugs.query.text import score_features
from tpugs.raster.api import plan_render as j_plan, rasterize_with_plan as j_raster
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs.viz import common as jcommon
from tpugs.viz import gif as jgif
from tpugs.viz import pca as jpca
from tpugs_torch.convert import SCENE_FIELDS, cameras_from_numpy, scene_from_numpy
from tpugs_torch.viz import common as tcommon
from tpugs_torch.viz import gif as tgif
from tpugs_torch.viz import pca as tpca

W, H = 48, 32


@pytest.fixture(scope="module")
def setup():
    js = random_scene(80, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(2, W, H, radius=2.5)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(4, 6))[rng.integers(0, 4, 80)] + 0.5 * rng.normal(size=(80, 6))
    feats = (feats / np.linalg.norm(feats, axis=1, keepdims=True)).astype(np.float32)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}, device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    return js, jc, ts, tc, feats


def _within_one(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.uint8 and g.shape == np.asarray(r).shape
        assert np.abs(g.astype(int) - np.asarray(r).astype(int)).max() <= 1


def test_checkerboard_to_uint8_and_overlay_match_tpugs():
    for args in ((128, 128), (70, 45, 16)):
        np.testing.assert_array_equal(tcommon.create_checkerboard(*args),
                                      jcommon.create_checkerboard(*args))
    img = np.random.default_rng(0).uniform(-0.2, 1.2, (9, 7, 3)).astype(np.float32)
    img[0, 0] = [1 / 255, 254.99 / 255, 0.5]
    np.testing.assert_array_equal(tcommon.to_uint8(torch.from_numpy(img)), jcommon.to_uint8(img))
    np.testing.assert_array_equal(tcommon.to_uint8(img), jcommon.to_uint8(img))
    frame = (np.random.default_rng(1).uniform(0, 1, (4, 5, 3)) * 255).astype(np.uint8)
    mask = np.random.default_rng(2).random((4, 5)) < 0.5
    np.testing.assert_array_equal(tgif.overlay_mask_red(frame, mask),
                                  jgif.overlay_mask_red(frame, mask))


@pytest.mark.parametrize("kw", [{}, {"use_checkerboard_background": True}, {"no_sh": True}])
def test_render_to_gif_frames_match_tpugs(setup, kw):
    js, jc, ts, tc, _ = setup
    _within_one(tgif.render_to_gif(None, ts, tc, **kw), jgif.render_to_gif(None, js, jc, **kw))


def test_render_to_gif_writes_the_gif_and_frames(setup, tmp_path):
    _, _, ts, tc, _ = setup
    out = str(tmp_path / "render.gif")
    frames = tgif.render_to_gif(out, ts, tc)
    assert len(frames) == 2 and os.path.exists(out)
    assert os.path.exists(out + ".images/frame_0001.png")


def test_render_mask_2d_to_gif_matches_tpugs(setup, tmp_path):
    js, jc, ts, tc, feats = setup
    pos, neg = feats[:2], feats[40:41]
    out = str(tmp_path / "mask.gif")
    got = tgif.render_mask_2d_to_gif(ts, torch.from_numpy(feats), torch.from_numpy(pos),
                                     torch.from_numpy(neg), tc, out)
    ref = jgif.render_mask_2d_to_gif(js, feats, pos, neg, jc, None)
    assert os.path.exists(out)
    _within_one(got, ref)
    # the masks themselves, where the margin is clear: the red channel moves
    for c in range(2):
        plan = j_plan(js.means, js.quats, js.scales, js.opacities, jc.viewmats[c], jc.Ks[c],
                      W, H)
        fimg, _ = j_raster(js.means, js.quats, js.scales, js.opacities, feats,
                           jc.viewmats[c], jc.Ks[c], plan)
        s = np.asarray(score_features(np.asarray(fimg).reshape(-1, 6),
                                      np.concatenate([pos, neg])))
        margin = np.abs(s[:, :2].max(1) - s[:, 2:].max(1)).reshape(H, W)
        ref_mask = (s[:, :2].max(1) > s[:, 2:].max(1)).reshape(H, W)
        assert 0 < ref_mask.sum() < H * W
        plain = jgif.render_to_gif(None, js, jc)[c].astype(int)
        moved = np.abs(got[c].astype(int) - plain).max(-1) > 1
        clear = (margin > 1e-4) & (plain[..., 0] < 250)  # near-white red barely moves
        np.testing.assert_array_equal(moved[clear], ref_mask[clear])


def test_feature_pca_and_colors_match_tpugs(setup):
    *_, feats = setup
    x = np.random.default_rng(3).normal(size=(300, 12)) @ np.diag(np.arange(12, 0, -1.0))
    for data in (x.astype(np.float32), feats):
        mean_j, comps_j = jpca.feature_pca(data)
        mean, comps = tpca.feature_pca(torch.from_numpy(data))
        np.testing.assert_allclose(mean.numpy(), mean_j, atol=1e-9)
        comps = comps.numpy()
        signs = np.sign(np.sum(comps * comps_j, axis=0))
        np.testing.assert_allclose(comps * signs, comps_j, atol=1e-6)
        cols_j, lo_j, hi_j = jpca.pca_colors(data, mean_j, comps_j)
        cols, lo, hi = tpca.pca_colors(torch.from_numpy(data), torch.from_numpy(mean_j),
                                       torch.from_numpy(comps_j.copy()))
        np.testing.assert_allclose(cols.numpy(), cols_j, atol=1e-6)
        np.testing.assert_allclose(lo.numpy(), lo_j, atol=1e-9)
        shared, _, _ = tpca.pca_colors(torch.from_numpy(data[:50]), torch.from_numpy(mean_j),
                                       torch.from_numpy(comps_j.copy()), lo, hi)
        ref, _, _ = jpca.pca_colors(data[:50], mean_j, comps_j, lo_j, hi_j)
        np.testing.assert_allclose(shared.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("mode", ["gaussian", "frame"])
def test_render_pca_matches_tpugs(setup, mode):
    js, jc, ts, tc, feats = setup
    got = tpca.render_pca(ts, torch.from_numpy(feats), tc, mode=mode)
    ref = jpca.render_pca(js, feats, jc, mode=mode)
    _within_one(got, ref)


def test_render_pca_unknown_mode_raises(setup):
    _, _, ts, tc, feats = setup
    with pytest.raises(ValueError, match="unknown pca mode"):
        tpca.render_pca(ts, torch.from_numpy(feats), tc, mode="pixel")
