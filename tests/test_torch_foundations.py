"""Port foundations against tpugs: synthetic scenes and rigs are
bit-identical from one seed, numpy state converts both ways exactly, and
the scene activations agree (to 1e-6 relative: exp/sigmoid of two
libraries)."""

import numpy as np
import pytest
import torch

from tpugs.encoders.base import LinearRGBEncoder as JLinearRGBEncoder
from tpugs.utils import synthetic as jsyn
from tpugs_torch.convert import (
    SCENE_FIELDS,
    cameras_from_numpy,
    linear_encoder_from_numpy,
    scene_from_numpy,
    scene_to_numpy,
)
from tpugs_torch.encoders.base import LinearRGBEncoder
from tpugs_torch.utils import synthetic as tsyn


def _jax_arrays(scene):
    return {k: np.asarray(getattr(scene, k)) for k in SCENE_FIELDS}


@pytest.mark.parametrize(
    "n,seed,sh_degree,scale_range",
    [(50, 0, 3, (0.02, 0.1)), (37, 5, 1, (0.01, 0.05)), (64, 2, 0, (0.004, 0.02))],
)
def test_random_scene_bit_identical(n, seed, sh_degree, scale_range):
    js = jsyn.random_scene(n, seed=seed, extent=0.8, scale_range=scale_range,
                           sh_degree=sh_degree)
    ts = tsyn.random_scene(n, seed=seed, extent=0.8, scale_range=scale_range,
                           sh_degree=sh_degree, device="cpu")
    for k, a in _jax_arrays(js).items():
        got = getattr(ts, k)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), a, err_msg=k)


@pytest.mark.parametrize("n_cams,width,height,radius", [(3, 64, 48, 2.5), (8, 1296, 840, 3.0)])
def test_orbit_cameras_bit_identical(n_cams, width, height, radius):
    jc = jsyn.orbit_cameras(n_cams, width, height, radius=radius)
    tc = tsyn.orbit_cameras(n_cams, width, height, radius=radius, device="cpu")
    np.testing.assert_array_equal(tc.viewmats.numpy(), np.asarray(jc.viewmats))
    np.testing.assert_array_equal(tc.Ks.numpy(), np.asarray(jc.Ks))
    assert (tc.width, tc.height, tc.num_cameras) == (jc.width, jc.height, n_cams)


def test_scene_numpy_round_trip():
    arrays = _jax_arrays(jsyn.random_scene(40, seed=1))
    back = scene_to_numpy(scene_from_numpy(arrays, device="cpu"))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


def test_scene_activations_match():
    js = jsyn.random_scene(80, seed=3)
    ts = scene_from_numpy(_jax_arrays(js), device="cpu")
    np.testing.assert_allclose(ts.opacities.numpy(), np.asarray(js.opacities), rtol=1e-6)
    np.testing.assert_allclose(ts.scales.numpy(), np.asarray(js.scales), rtol=1e-6)
    np.testing.assert_array_equal(ts.colors_all.numpy(), np.asarray(js.colors_all))
    assert ts.sh_degree == js.sh_degree and ts.num_gaussians == js.num_gaussians


def test_linear_encoder_draws_the_same_projection():
    je = JLinearRGBEncoder(24, seed=3)
    te = LinearRGBEncoder(24, seed=3, device="cpu")
    np.testing.assert_array_equal(te.proj.numpy(), np.asarray(je._proj))
    img = np.random.default_rng(0).uniform(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        te(torch.from_numpy(img)).numpy(), np.asarray(je(img)), rtol=1e-5, atol=1e-6
    )
    conv = linear_encoder_from_numpy(np.asarray(je._proj), device="cpu")
    np.testing.assert_array_equal(conv.proj.numpy(), te.proj.numpy())
    assert conv.feature_dim == 24 and conv.pixelwise


def test_cameras_from_numpy_checks_shapes():
    vm, ks = tsyn.orbit_arrays(2, 32, 32)
    with pytest.raises(ValueError):
        cameras_from_numpy(vm[:, :3], ks, 32, 32, device="cpu")
    with pytest.raises(ValueError):
        cameras_from_numpy(vm, ks[:1], 32, 32, device="cpu")


def test_grayscale_and_patch_average_encoders_match():
    from tpugs.encoders.base import GrayscaleEncoder as JGray
    from tpugs.encoders.base import PatchAverageEncoder as JPatch
    from tpugs_torch.encoders.base import GrayscaleEncoder, PatchAverageEncoder

    img = np.random.default_rng(1).uniform(size=(21, 30, 3)).astype(np.float32)
    t_img = torch.from_numpy(img)
    np.testing.assert_allclose(GrayscaleEncoder()(t_img).numpy(),
                               np.asarray(JGray()(img)), rtol=1e-6, atol=1e-7)
    jp = JPatch(JLinearRGBEncoder(6, seed=2), patch=8)
    tp = PatchAverageEncoder(LinearRGBEncoder(6, seed=2, device="cpu"), patch=8)
    got = tp(t_img)
    assert got.shape == (21, 30, 6) and tp.feature_dim == 6
    np.testing.assert_allclose(got.numpy(), np.asarray(jp(img)), rtol=1e-5, atol=1e-6)


def test_make_viewmat_and_intrinsics_match():
    from tpugs.core.camera import intrinsics_matrix as j_intrinsics
    from tpugs.core.camera import make_viewmat as j_make_viewmat
    from tpugs_torch.core.camera import intrinsics_matrix, make_viewmat

    rng = np.random.default_rng(7)
    R = rng.normal(size=(3, 3)).astype(np.float32)
    t = rng.normal(size=(3,)).astype(np.float32)
    np.testing.assert_array_equal(
        make_viewmat(torch.from_numpy(R), torch.from_numpy(t)).numpy(),
        np.asarray(j_make_viewmat(R, t)))
    np.testing.assert_array_equal(intrinsics_matrix(100.0, 90.0, 32, 24),
                                  j_intrinsics(100.0, 90.0, 32, 24))
