"""B1's plain twin against tpugs' ``render_pallas_raw`` (exact path,
``mxu_prefix=False``, Pallas in interpret mode) on the same numpy-seeded
scene. 64x48 with tile 32 leaves a partial tile row; the dense scene makes
tiles exit early at the default ``trans_eps``. Tolerance 3e-5 absolute:
the port's running transmittance product against the reference's
doubling-tree product, and the projections' float differences."""

import numpy as np
import pytest
import torch

from tpugs.lift.pallas_batch import estimate_sizes_pallas
from tpugs.raster.adjoint import image_to_tiles as j_image_to_tiles
from tpugs.raster.api import _prepare_colors as j_prepare_colors
from tpugs.raster.pallas_tiled import build_plan_pure
from tpugs.raster.pallas_tiled import pack_isect_all as j_pack
from tpugs.raster.pallas_tiled import render_pallas_raw, render_view_pallas
from tpugs.raster.pallas_tiled import tiles_to_image as j_tiles_to_image
from tpugs.raster.projection import project as j_project
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import SCENE_FIELDS, cameras_from_numpy, scene_from_numpy
from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.kernels import TRANS_EPS, render_tiles
from tpugs_torch.raster.pack import pack_isect_all
from tpugs_torch.raster.plan import build_plan
from tpugs_torch.raster.projection import project
from tpugs_torch.raster.tiled import render_view
from tpugs_torch.raster.tiles import image_to_tiles, tiles_to_image

W, H = 64, 48
CASES = [(cam, tile) for cam in (0, 1) for tile in (16, 32)]


@pytest.fixture(scope="module")
def views():
    js = random_scene(600, seed=0, extent=1.0, scale_range=(0.08, 0.25))
    jc = orbit_cameras(2, W, H, radius=1.8)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                          device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    sizes = {t: estimate_sizes_pallas(js, jc, tile_size=t) for t in (16, 32)}

    def get(cam, tile):
        vm, K = jc.viewmats[cam], jc.Ks[cam]
        jargs = (js.means, js.quats, js.scales, js.opacities)
        jp = build_plan_pure(*jargs, vm, K, W, H, sizes[tile], tile_size=tile)
        jproj = j_project(*jargs, vm, K, W, H)
        jpack = j_pack(jproj, j_prepare_colors(js.means, js.colors_all, vm, 3), jp)
        tproj = project(ts.means, ts.quats, ts.scales, ts.opacities,
                        tc.viewmats[cam], tc.Ks[cam], W, H)
        tp = build_plan(tproj, W, H, tile)
        tpack = pack_isect_all(
            tproj, prepare_colors(ts.means, ts.colors_all, tc.viewmats[cam], 3), tp)
        return (js, jc, jp, jpack), (ts, tc, tp, tpack)

    return get


@pytest.mark.parametrize("cam,tile", CASES)
def test_render_twin_matches_pallas(views, cam, tile):
    (_, _, jp, jpack), (_, _, tp, tpack) = views(cam, tile)
    ref = np.asarray(render_pallas_raw(jpack, jp, 4, interpret=True, mxu_prefix=False))
    got, done = render_tiles(tpack, tp)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5)
    nb = (tp.tile_ends - tp.tile_starts + 127) // 128
    assert bool((done <= nb).all())


def test_scene_has_early_exits_and_partial_tiles(views):
    _, (_, _, tp, tpack) = views(0, 32)
    _, done = render_tiles(tpack, tp, TRANS_EPS)
    nb = (tp.tile_ends - tp.tile_starts + 127) // 128
    assert bool((done < nb).any()), "a tile exits early"
    assert H % 32 != 0, "the last tile row is partial"


@pytest.mark.parametrize("cam", [0, 1])
def test_render_view_image_matches(views, cam):
    (js, jc, jp, _), (ts, tc, tp, _) = views(cam, 32)
    img_j, alpha_j = render_view_pallas(
        js.means, js.quats, js.scales, js.opacities, js.colors_all,
        jc.viewmats[cam], jc.Ks[cam], jp, sh_degree=3, interpret=True)
    img, alpha = render_view(
        ts.means, ts.quats, ts.scales, ts.opacities, ts.colors_all,
        tc.viewmats[cam], tc.Ks[cam], tp, sh_degree=3)
    assert img.shape == (H, W, 3) and alpha.shape == (H, W)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=3e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j), atol=3e-5)


@pytest.mark.parametrize("tile", [16, 32])
def test_image_tile_layout_matches(tile):
    img = np.random.default_rng(tile).normal(size=(H, W, 3)).astype(np.float32)
    tiles = image_to_tiles(torch.from_numpy(img), tile)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(j_image_to_tiles(img, tile)))
    back = tiles_to_image(tiles, W, H, tile)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j_tiles_to_image(
        np.asarray(tiles.numpy()), W, H, tile)))
    np.testing.assert_array_equal(back.numpy(), img)
