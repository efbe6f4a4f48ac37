"""The port's affordance transfer (``tpugs_torch.query.affordance``)
against tpugs' (JAX on the CPU), on the scene of tpugs' own affordance
tests (80 Gaussians, 3 orbit views at 48x32) and a seeded 8-d field
shaped like a lifted one (unit rows, some zero), handed to both packages.

* ``load_exemplars`` on labelme JSON (a base64 PNG mask, a polygon, and a
  mask at another size than the feature map): the same bank (1e-6) and
  labels; ``decode_labelme_mask`` equal;
* ``transfer_affordance`` (k 1, 3, 5 and ``min_similarity``) equal labels;
  with k = 1 each exemplar's source Gaussian keeps its label;
* ``colorize_by_labels`` 1e-6; ``render_label_masks`` equal label maps on
  every view;
* ``load_mat_gt`` (sorting, the automatic view skipped), ``resize_nearest``
  (floor indexing) and ``evaluate_iou`` equal;
* ``vote_gradient`` 1e-5 (it is B2 with f32 rows and B3 on the CPU twins,
  against tpugs' tiled adjoint), ``vote_binary`` equal where the gradient
  vote is more than 1e-4 from 0.5, ``vote_projection`` equal; an all-ones
  mask votes 1 where a Gaussian has weight and an all-zeros mask 0.
"""

import base64
import io
import json

import numpy as np
import pytest
import torch

from tpugs.encoders.base import LinearRGBEncoder as JLinear
from tpugs.query import affordance as ja
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import SCENE_FIELDS, scene_from_numpy, scene_to_numpy
from tpugs_torch.encoders.base import LinearRGBEncoder
from tpugs_torch.lift.ops import accumulate_view
from tpugs_torch.query import affordance as ta

W, H = 48, 32


def _field(n, d, seed=0):
    """A lifted field's shape: unit rows around a few directions, every
    tenth row zero (no weight in any view)."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(6, d))[rng.integers(0, 6, n)] + 0.4 * rng.normal(size=(n, d))
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    f[::10] = 0
    return f.astype(np.float32)


@pytest.fixture(scope="module")
def lifted():
    js = random_scene(80, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(3, W, H, radius=2.5)
    feats = _field(80, 8)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}, device="cpu")
    return js, jc, ts, feats


def _png_b64(mask):
    import imageio.v2 as imageio

    buf = io.BytesIO()
    imageio.imwrite(buf, mask, format="png")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def exemplar_dir(tmp_path_factory):
    import imageio.v2 as imageio

    root = tmp_path_factory.mktemp("exemplars")
    rng = np.random.default_rng(0)
    imageio.imwrite(str(root / "ex.png"), (rng.uniform(0, 1, (16, 16, 3)) * 255).astype(np.uint8))
    imageio.imwrite(str(root / "big.png"), (rng.uniform(0, 1, (12, 20, 3)) * 255).astype(np.uint8))
    mask = np.zeros((16, 16), np.uint8)
    mask[:8, :8] = 255
    small = np.zeros((6, 10), np.uint8)  # another size than its image: resized
    small[1:5, 2:9] = 255
    (root / "ex.json").write_text(json.dumps({"imagePath": "ex.png", "shapes": [
        {"label": "grasp", "mask": _png_b64(mask)},
        {"label": "contain", "points": [[8, 8], [15, 8], [15, 15], [8, 15]]},
        {"label": "unknown", "points": [[0, 0], [3, 0], [3, 3]]},
    ]}))
    (root / "big.json").write_text(json.dumps({"imagePath": "big.png", "shapes": [
        {"label": "cut", "mask": _png_b64(small)},
        {"label": "wrap", "points": [[0, 0], [19, 0], [19, 5], [0, 5]]},
    ]}))
    return root


def test_load_exemplars_matches_tpugs(exemplar_dir):
    ref = ja.load_exemplars(str(exemplar_dir), JLinear(feature_dim=5))
    got = ta.load_exemplars(str(exemplar_dir), LinearRGBEncoder(5, device="cpu"), device="cpu")
    assert got.labels.tolist() == ref.labels.tolist() == [
        ta.AFFORDANCE_CLASSES.index(n) for n in ("cut", "wrap", "grasp", "contain")]
    np.testing.assert_allclose(got.features, ref.features, atol=1e-6)
    mask = np.zeros((5, 7), np.uint8)
    mask[2:4, 1:6] = 200
    b64 = _png_b64(mask)
    np.testing.assert_array_equal(ta.decode_labelme_mask(b64), ja.decode_labelme_mask(b64))


def _bank(feats, rows, labels, noise, seed):
    rng = np.random.default_rng(seed)
    f = feats[rows] + noise * rng.normal(size=(len(rows), feats.shape[1]))
    return ta.ExemplarBank(f.astype(np.float32), np.asarray(labels, np.int64))


def test_transfer_affordance_matches_tpugs(lifted):
    _, _, _, feats = lifted
    rows = np.random.default_rng(1).choice(80, 24, replace=False)
    bank = _bank(feats, rows, 1 + np.arange(24) % 7, 0.05, 2)
    jbank = ja.ExemplarBank(bank.features, bank.labels)
    for k in (1, 3, 5):
        ref = ja.transfer_affordance(feats, jbank, k=k)
        got = ta.transfer_affordance(torch.from_numpy(feats), bank, k=k)
        assert got.shape == (80,)
        np.testing.assert_array_equal(got, np.asarray(ref))
    ref = ja.transfer_affordance(feats, jbank, k=3, min_similarity=0.99)
    got = ta.transfer_affordance(torch.from_numpy(feats), bank, k=3, min_similarity=0.99)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert 0 < (got == 0).sum() < 80
    exact = _bank(feats, rows, 1 + np.arange(24) % 7, 0.0, 2)
    lit = np.abs(feats[rows]).sum(1) > 0
    got = ta.transfer_affordance(torch.from_numpy(feats), exact, k=1)
    np.testing.assert_array_equal(got[rows][lit], exact.labels[lit])


def test_colorize_and_label_masks_match_tpugs(lifted):
    js, jc, ts, _ = lifted
    labels = np.random.default_rng(3).integers(0, 8, 80)
    ref = ja.colorize_by_labels(js, labels)
    got = scene_to_numpy(ta.colorize_by_labels(ts, labels))
    np.testing.assert_allclose(got["sh0"], np.asarray(ref.sh0), atol=1e-6)
    np.testing.assert_array_equal(got["shN"], np.asarray(ref.shN))
    for c in range(3):
        vm, K = np.array(jc.viewmats[c]), np.array(jc.Ks[c])
        pred_j = ja.render_label_masks(js, labels, vm, K, W, H)
        pred = ta.render_label_masks(ts, labels, vm, K, W, H)
        assert pred.shape == (H, W) and pred.dtype == np.int64
        assert len(np.unique(pred)) > 2
        np.testing.assert_array_equal(pred, pred_j)


def test_mat_gt_resize_and_iou_match_tpugs(tmp_path):
    from scipy.io import savemat

    a = np.arange(12, dtype=np.int64).reshape(3, 4) % 3
    savemat(str(tmp_path / "b_label.mat"), {"gt_label": a, "gt_type": "manual"})
    savemat(str(tmp_path / "a_label.mat"), {"gt_label": a * 0, "gt_type": "automatic"})
    savemat(str(tmp_path / "c_label.mat"), {"gt_label": a + 1})
    (tmp_path / "notes.txt").write_text("ignored")
    got, ref = ta.load_mat_gt(str(tmp_path)), ja.load_mat_gt(str(tmp_path))
    assert [i for i, _ in got] == [i for i, _ in ref] == [1, 2]
    for (_, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    rng = np.random.default_rng(4)
    m = rng.integers(0, 8, (7, 9))
    for hw in ((7, 9), (14, 18), (5, 4), (11, 13)):
        np.testing.assert_array_equal(ta.resize_nearest(m, *hw), ja.resize_nearest(m, *hw))
    preds = [rng.integers(0, 8, (6, 5)) for _ in range(3)]
    gts = [np.where(rng.random((6, 5)) < 0.7, p, rng.integers(0, 8, (6, 5))) for p in preds]
    gts[0][gts[0] == 6] = 0  # a class with no ground truth
    assert ta.evaluate_iou(preds, gts) == ja.evaluate_iou(preds, gts)


def test_votes_match_tpugs(lifted):
    js, jc, ts, _ = lifted
    vm, K = np.array(jc.viewmats[0]), np.array(jc.Ks[0])
    mask = np.zeros((H, W), bool)
    mask[:, : W // 2] = True
    mask[5:9, 30:40] = True
    g_ref = ja.vote_gradient(js, vm, K, W, H, mask)
    g = ta.vote_gradient(ts, vm, K, W, H, mask)
    np.testing.assert_allclose(g, g_ref, atol=1e-5)
    clear = np.abs(g_ref - 0.5) > 1e-4
    np.testing.assert_array_equal(ta.vote_binary(ts, vm, K, W, H, mask)[clear],
                                  ja.vote_binary(js, vm, K, W, H, mask)[clear])
    np.testing.assert_array_equal(ta.vote_projection(ts, vm, K, W, H, mask),
                                  ja.vote_projection(js, vm, K, W, H, mask))
    # all ones: num = den wherever there is weight; all zeros: 0
    ones = ta.vote_gradient(ts, vm, K, W, H, np.ones((H, W), bool))
    _, den = accumulate_view(ts, torch.from_numpy(vm), torch.from_numpy(K), W, H, device="cpu")
    weighted = den.numpy() > 1e-6
    assert weighted.sum() > 40
    np.testing.assert_allclose(ones[weighted], 1.0, rtol=1e-6)
    np.testing.assert_array_equal(ones[den.numpy() == 0], 0)
    np.testing.assert_array_equal(ta.vote_gradient(ts, vm, K, W, H, np.zeros((H, W), bool)), 0)
