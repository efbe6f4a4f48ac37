"""The port's queries and edits (``tpugs_torch.query``: text, masks, knn)
against tpugs' (JAX on the CPU, each reference under ``jax.jit``), on
numpy-seeded inputs.

* ``score_features``: 1e-6 absolute (cosines in [-1, 1]);
* ``get_mask3d`` (with and without a threshold) and ``get_mask2d``: equal
  masks wherever the deciding margin (max positive - max negative score,
  and the first score against the threshold) exceeds 1e-4; inputs are
  drawn so that most rows clear it;
* ``apply_mask3d`` (extracted / deleted / masked scenes) bit-equal;
  ``segment_by_opacity`` bit-equal; ``recolor`` 1e-6;
* ``knn_search``: scores 1e-6, indices equal on tie-free data; on a bank
  of duplicated rows, ties inside the k come back in ``jax.lax.top_k``'s
  order and at the edge of the k the lower index wins, as in
  ``jax.lax.top_k`` (a zero query ties with the whole bank);
  ``transfer_labels`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.query import knn as jknn
from tpugs.query import masks as jmasks
from tpugs.query import text as jtext
from tpugs.utils.synthetic import random_scene
from tpugs_torch.convert import SCENE_FIELDS, scene_from_numpy, scene_to_numpy
from tpugs_torch.query import knn as tknn
from tpugs_torch.query import masks as tmasks
from tpugs_torch.query import text as ttext

MARGIN = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _clustered(rng, n, d, centres, noise=0.3):
    """n rows near random picks of ``centres``: clear margins for most."""
    pick = rng.integers(0, len(centres), n)
    return (centres[pick] + noise * rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(0)
    d = 16
    centres = rng.normal(size=(5, d))
    feats = _clustered(rng, 600, d, centres)
    pos = (centres[:2] + 0.05 * rng.normal(size=(2, d))).astype(np.float32)
    neg = (centres[2:] + 0.05 * rng.normal(size=(3, d))).astype(np.float32)
    return feats, pos, neg


def test_score_features_matches_tpugs(field):
    feats, pos, neg = field
    q = np.concatenate([pos, neg])
    ref = np.asarray(jax.jit(jtext.score_features)(feats, q))
    got = ttext.score_features(_t(feats), _t(q)).numpy()
    assert got.shape == ref.shape == (600, 5)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _margin_rows(score, p, threshold=None):
    margin = np.abs(score[:, :p].max(1) - score[:, p:].max(1)) > MARGIN
    if threshold is not None:
        margin &= np.abs(score[:, 0] - threshold) > MARGIN
    return margin


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_get_mask3d_matches_tpugs(field, threshold):
    feats, pos, neg = field
    ref, ref_inv = jax.jit(jtext.get_mask3d, static_argnums=3)(feats, pos, neg, threshold)
    got, got_inv = ttext.get_mask3d(_t(feats), _t(pos), _t(neg), threshold)
    score = np.asarray(jtext.score_features(feats, np.concatenate([pos, neg])))
    keep = _margin_rows(score, 2, threshold)
    assert keep.mean() > 0.95
    ref, got = np.asarray(ref), got.numpy()
    assert got.dtype == bool and 0 < ref[keep].sum() < keep.sum()
    np.testing.assert_array_equal(got[keep], ref[keep])
    np.testing.assert_array_equal(got_inv.numpy(), ~got)
    np.testing.assert_array_equal(np.asarray(ref_inv), ~ref)


def test_get_mask2d_matches_tpugs(field):
    feats, pos, neg = field
    img = feats[:600].reshape(20, 30, 16)
    ref = np.asarray(jax.jit(jtext.get_mask2d)(img, pos, neg))
    got = ttext.get_mask2d(_t(img), _t(pos), _t(neg)).numpy()
    score = np.asarray(jtext.score_features(feats, np.concatenate([pos, neg])))
    keep = _margin_rows(score, 2).reshape(20, 30)
    assert got.shape == (20, 30)
    np.testing.assert_array_equal(got[keep], ref[keep])


def test_highest_precision_restores_the_callers_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with ttext.highest_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.fixture(scope="module")
def scenes():
    js = random_scene(40, seed=1, sh_degree=3)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}, device="cpu")
    mask = np.random.default_rng(2).random(40) < 0.4
    return js, ts, mask


def _same_scene(got, ref, atol=0.0):
    arrays = scene_to_numpy(got)
    for k in SCENE_FIELDS:
        np.testing.assert_allclose(arrays[k], np.asarray(getattr(ref, k)), atol=atol, rtol=0,
                                   err_msg=k)


def test_apply_mask3d_matches_tpugs(scenes):
    js, ts, mask = scenes
    refs = jmasks.apply_mask3d(js, mask)
    gots = tmasks.apply_mask3d(ts, torch.from_numpy(mask))
    for got, ref in zip(gots, refs):
        _same_scene(got, ref)
    assert gots[0].num_gaussians + gots[1].num_gaussians == 40
    # an explicit inverse that is not ~mask
    inv = np.zeros(40, bool)
    inv[:3] = True
    _same_scene(tmasks.apply_mask3d(ts, mask, inv)[1], jmasks.apply_mask3d(js, mask, inv)[1])


def test_segment_by_opacity_and_recolor_match_tpugs(scenes):
    js, ts, mask = scenes
    _same_scene(tmasks.segment_by_opacity(ts, torch.from_numpy(mask)),
                jmasks.segment_by_opacity(js, mask))
    _same_scene(tmasks.segment_by_opacity(ts, mask, hidden_logit=-12.0),
                jmasks.segment_by_opacity(js, mask, hidden_logit=-12.0))
    for rgb, strength in (((1.0, 0.0, 0.0), 1.0), ((0.2, 0.7, 0.4), 0.6)):
        _same_scene(tmasks.recolor(ts, mask, rgb, strength),
                    jmasks.recolor(js, mask, rgb, strength), atol=1e-6)


@pytest.mark.parametrize("k", [1, 5])
def test_knn_search_matches_tpugs(k):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(300, 12)).astype(np.float32)
    bank = rng.normal(size=(40, 12)).astype(np.float32)
    s_ref, i_ref = jknn.knn_search(q, bank, k=k)
    s_got, i_got = tknn.knn_search(_t(q), _t(bank), k)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref), atol=1e-6)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("k", [2, 4, 6])
def test_knn_ties_keep_lax_top_k_rule(k):
    """Duplicated bank rows tie exactly, and a zero query ties with the
    whole bank: the lower index wins inside the k and at its edge, as in
    ``jax.lax.top_k``."""
    rng = np.random.default_rng(4)
    base = rng.normal(size=(6, 8)).astype(np.float32)
    bank = np.concatenate([base, base, base])  # rows i, i + 6, i + 12 tie
    q = rng.normal(size=(50, 8)).astype(np.float32)
    q[::7] = 0
    s_ref, i_ref = jknn.knn_search(q, bank, k=k)  # k = 2, 4: ties across the edge of the k
    s_got, i_got = tknn.knn_search(_t(q), _t(bank), k)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref), atol=1e-6)


def test_transfer_labels_matches_tpugs():
    rng = np.random.default_rng(5)
    centres = rng.normal(size=(4, 10))
    bank = _clustered(rng, 60, 10, centres, noise=0.2)
    labels = (np.arange(60) % 8).astype(np.int32)  # mixed votes: argmax ties break low
    q = _clustered(rng, 400, 10, centres, noise=0.5)
    for k in (1, 3, 5):
        ref = jknn.transfer_labels(q, bank, labels, k=k, num_classes=8)
        got = tknn.transfer_labels(_t(q), _t(bank), torch.from_numpy(labels).long(), k, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # labels outside [0, num_classes) vote for no class, as jax.nn.one_hot has it
    wild = labels.copy()
    wild[::3] = 9
    ref = jknn.transfer_labels(q, bank, wild, k=5, num_classes=8)
    got = tknn.transfer_labels(_t(q), _t(bank), torch.from_numpy(wild).long(), 5, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
