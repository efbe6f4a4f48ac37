"""The split-encoder lift: the port's ``backproject_views_split`` against
tpugs' ``backproject_views_grouped_split`` (Pallas in interpret mode) on
about 300 Gaussians, 3 views in groups of 2 (the last group is short), a
tiny LSeg encoder (ViT width 16, 4 blocks, patch 8, 32^2 crop, 16-d output)
with the same seeded lang-seg state dict in both packages, 96 x 64, tile 32.

* against tpugs at f32 and at bf16 rows: tpugs' own split budget, 1e-2 of
  the max (``tests/test_pallas.py:297-300``); den at f32 to 1e-4 of max;
* against the port's ``backproject_views`` with the same encoder: den
  bit-equal (the same renders and order of sums); num bit-equal at bf16
  rows (the same bf16 features), within one bf16 rounding (2^-8 of max) at
  f32 rows, where only the split rounds the features to bf16;
* the three reduce engines ("scatter" bit-equal to "pallas", "xla" to
  1e-5 of max) and ``cam_weights``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_encoders import TINY_LSEG, _lseg_sd, _port_lseg, _tpugs_lseg_encoder
from tpugs.lift.pallas_batch import backproject_views_grouped_split, estimate_sizes_pallas
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import SCENE_FIELDS, cameras_from_numpy, scene_from_numpy
from tpugs_torch.encoders.lseg import LSegEncoder
from tpugs_torch.lift.batch import backproject_views, backproject_views_split

W, H, TILE, VIEWS, CROP = 96, 64, 32, 3, 32
D = TINY_LSEG["out_dim"]


@pytest.fixture(scope="module")
def setup():
    js = random_scene(300, seed=4, extent=0.8, scale_range=(0.02, 0.12))
    jc = orbit_cameras(VIEWS, W, H, radius=2.5)
    sd = _lseg_sd(8)
    jenc = _tpugs_lseg_encoder(sd, CROP)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                          device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    enc = LSegEncoder.from_net(_port_lseg(sd, image_size=CROP), crop_size=CROP)
    return js, jc, jenc, ts, tc, enc


def _tpugs(setup, dtype):
    js, jc, jenc, *_ = setup
    sizes = estimate_sizes_pallas(js, jc, tile_size=TILE)
    num, den = backproject_views_grouped_split(
        js, jc.viewmats, jc.Ks, W, H, jenc, sizes, group_size=2, d_chunk=128,
        interpret=True, tile_size=TILE, contrib_dtype=dtype)
    return np.asarray(num), np.asarray(den)


def _port(setup, dtype=torch.bfloat16, **kw):
    *_, ts, tc, enc = setup
    return backproject_views_split(ts, tc.viewmats, tc.Ks, W, H, enc, group_size=2,
                                   tile_size=TILE, contrib_dtype=dtype, device="cpu", **kw)


def _within(got, ref, frac, what):
    scale = float(np.abs(ref).max())
    assert scale > 0
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_matches_tpugs(setup, dtype):
    num_j, den_j = _tpugs(setup, getattr(jnp, dtype))
    num, den = _port(setup, getattr(torch, dtype))
    assert num.shape == (300, D) and den.shape == (300,)
    assert (den_j > 0).mean() > 0.3
    _within(num.numpy(), num_j, 1e-2, "num")
    _within(den.numpy(), den_j, 1e-4 if dtype == "float32" else 1e-2, "den")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_equals_one_pass_lift(setup, dtype):
    *_, ts, tc, enc = setup
    num, den = _port(setup, dtype)
    num_1, den_1 = backproject_views(ts, tc.viewmats, tc.Ks, W, H, enc, tile_size=TILE,
                                     contrib_dtype=dtype, device="cpu")
    assert torch.equal(den, den_1)
    if dtype == torch.bfloat16:
        assert torch.equal(num, num_1)
    else:  # the split rounds the features to bf16 before the f32 rows
        _within(num.numpy(), num_1.numpy(), 2.0**-8, "num")
        assert not torch.equal(num, num_1)


def test_reduce_engines(setup):
    num, den = _port(setup)
    num_s, den_s = _port(setup, reduce_engine="scatter")
    assert torch.equal(num_s, num) and torch.equal(den_s, den)
    num_x, den_x = _port(setup, reduce_engine="xla")
    _within(num_x.numpy(), num.numpy(), 1e-5, "xla num")
    _within(den_x.numpy(), den.numpy(), 1e-5, "xla den")
    with pytest.raises(ValueError):
        _port(setup, reduce_engine="mosaic")


def test_cam_weights(setup):
    *_, ts, tc, enc = setup
    w = torch.tensor([1.0, 0.0, 2.0])
    num, den = _port(setup, cam_weights=w)
    num_1, den_1 = backproject_views(ts, tc.viewmats, tc.Ks, W, H, enc, tile_size=TILE,
                                     device="cpu", cam_weights=w)
    assert torch.equal(num, num_1) and torch.equal(den, den_1)
    num_0, den_0 = _port(setup, cam_weights=torch.tensor([1.0, 0.0, 0.0]))
    num_2, den_2 = _port(setup, cam_weights=torch.tensor([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(den.numpy(), (den_0 + 2 * den_2).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(num.numpy(), (num_0 + 2 * num_2).numpy(), rtol=1e-6, atol=1e-6)


def test_encoder_without_staged_apply_runs_per_image(setup):
    """An encoder without ``staged_apply`` (here the linear one) runs on each
    image and its features are rounded to bf16, as tpugs'
    ``_encode_images_jit`` does: the one-pass lift at bf16 rows computes
    the same sums."""
    from tpugs_torch.encoders.base import LinearRGBEncoder

    *_, ts, tc, _ = setup
    enc = LinearRGBEncoder(8, seed=3, device="cpu")
    num, den = backproject_views_split(ts, tc.viewmats, tc.Ks, W, H, enc, group_size=2,
                                       tile_size=TILE, device="cpu")
    num_1, den_1 = backproject_views(ts, tc.viewmats, tc.Ks, W, H, enc, tile_size=TILE,
                                     device="cpu")
    assert torch.equal(den, den_1)
    _within(num.numpy(), num_1.numpy(), 1e-6, "num")
