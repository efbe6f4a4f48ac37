"""Port projection and SH against tpugs on the same numpy-seeded scene.
The validity mask must match exactly; float fields agree to 1e-5
relative (the two libraries order the small matrix products
differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.raster.api import _prepare_colors as j_prepare_colors
from tpugs.raster.projection import ProjectionConfig as JConfig
from tpugs.raster.projection import project as j_project
from tpugs.raster.sh import sh_to_color as j_sh_to_color
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import SCENE_FIELDS, cameras_from_numpy, scene_from_numpy
from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.projection import ProjectionConfig, project
from tpugs_torch.raster.sh import sh_to_color

W, H = 160, 96


@pytest.fixture(scope="module")
def scenes():
    js = random_scene(500, seed=4, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(2, W, H, radius=2.5)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                          device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    return js, jc, ts, tc


def _close(got, ref, name):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("antialiased", [False, True])
@pytest.mark.parametrize("cam", [0, 1])
def test_projection_fields_match(scenes, cam, antialiased):
    js, jc, ts, tc = scenes
    jp = j_project(js.means, js.quats, js.scales, js.opacities, jc.viewmats[cam],
                   jc.Ks[cam], W, H, JConfig(antialiased=antialiased))
    tp = project(ts.means, ts.quats, ts.scales, ts.opacities, tc.viewmats[cam],
                 tc.Ks[cam], W, H, ProjectionConfig(antialiased=antialiased))
    valid = np.asarray(jp.valid)
    np.testing.assert_array_equal(tp.valid.numpy(), valid)
    assert valid.sum() > 100
    for name in ("means2d", "conics", "depths", "radii", "opacities", "cut_r2", "sig_cut"):
        _close(getattr(tp, name).numpy()[valid], np.asarray(getattr(jp, name))[valid], name)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_colors_match(scenes, degree):
    js, jc, ts, tc = scenes
    dirs = np.random.default_rng(degree).normal(size=(500, 3)).astype(np.float32)
    ref = j_sh_to_color(js.colors_all, jnp.asarray(dirs), degree)
    got = sh_to_color(ts.colors_all, torch.from_numpy(dirs), degree)
    _close(got.numpy(), ref, f"sh degree {degree}")


def test_prepare_colors_match(scenes):
    js, jc, ts, tc = scenes
    ref = j_prepare_colors(js.means, js.colors_all, jc.viewmats[1], js.sh_degree)
    got = prepare_colors(ts.means, ts.colors_all, tc.viewmats[1], ts.sh_degree)
    _close(got.numpy(), ref, "colors")
    direct = prepare_colors(ts.means, ts.sh0, tc.viewmats[1], None)
    np.testing.assert_array_equal(direct.numpy(), ts.sh0[:, 0].numpy())
