"""B2's plain twin against tpugs' adjoint (exact path, Pallas in interpret
mode) on the same numpy-seeded scene and feature tiles.

* f32: contribution rows and the reduced (num, den) to 1e-4 x max|ref|
  (matmul summation order).
* bf16 rows, reduced, against the same f32 exact reference: den within
  0.5% and num within 1% of max, the budget of tests/test_pallas.py. Not
  against tpugs' bf16 path, whose log-space weights carry their own error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.lift.pallas_batch import estimate_sizes_pallas
from tpugs.raster.api import _prepare_colors as j_prepare_colors
from tpugs.raster.pallas_tiled import adjoint_pallas_raw, backproject_view_pallas
from tpugs.raster.pallas_tiled import build_plan_pure
from tpugs.raster.pallas_tiled import pack_isect_all as j_pack
from tpugs.raster.projection import project as j_project
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import SCENE_FIELDS, cameras_from_numpy, scene_from_numpy
from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.kernels import (
    CHANNEL_SLICE, MAX_CLUSTER, ROWS_TOL, adjoint_cluster, adjoint_rows, contrib_width, rows_error)
from tpugs_torch.raster.pack import pack_isect_all
from tpugs_torch.raster.plan import build_plan
from tpugs_torch.raster.projection import project
from tpugs_torch.raster.tiled import backproject_view

W, H, D = 64, 48, 20


@pytest.fixture(scope="module")
def views():
    js = random_scene(600, seed=0, extent=1.0, scale_range=(0.08, 0.25))
    jc = orbit_cameras(2, W, H, radius=1.8)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                          device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    sizes = {t: estimate_sizes_pallas(js, jc, tile_size=t) for t in (16, 32)}
    cache = {}

    def get(tile):
        if tile not in cache:
            vm, K = jc.viewmats[0], jc.Ks[0]
            jargs = (js.means, js.quats, js.scales, js.opacities)
            jp = build_plan_pure(*jargs, vm, K, W, H, sizes[tile], tile_size=tile)
            jpack = j_pack(j_project(*jargs, vm, K, W, H),
                           j_prepare_colors(js.means, js.colors_all, vm, 3), jp)
            tproj = project(ts.means, ts.quats, ts.scales, ts.opacities,
                            tc.viewmats[0], tc.Ks[0], W, H)
            tp = build_plan(tproj, W, H, tile)
            tpack = pack_isect_all(
                tproj, prepare_colors(ts.means, ts.colors_all, tc.viewmats[0], 3), tp)
            feats = np.random.default_rng(tile).normal(
                size=(tp.n_tiles, tile * tile, D)).astype(np.float32)
            fs, ws = backproject_view_pallas(
                *jargs, None, vm, K, jp, d_chunk=128, interpret=True,
                contrib_dtype=jnp.float32, packed=jpack, reduce_engine="pallas",
                feat_tiles=jnp.asarray(feats))
            cache[tile] = (jp, jpack, tp, tpack, feats, np.asarray(fs), np.asarray(ws))
        return cache[tile]

    return get


def _within(got, ref, frac, what):
    scale = float(np.abs(ref).max())
    assert scale > 0
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


@pytest.mark.parametrize("tile", [16, 32])
def test_adjoint_f32_matches_pallas(views, tile):
    jp, jpack, tp, tpack, feats, fs, ws = views(tile)
    num, den = backproject_view(tpack, torch.from_numpy(feats), tp)
    _within(den.numpy(), ws, 1e-4, "den")
    _within(num.numpy(), fs, 1e-4, "num")


@pytest.mark.parametrize("tile", [16, 32])
def test_adjoint_f32_rows_match_pallas(views, tile):
    """Row by row, including the zero rows of blocks skipped by the early
    exit and the ones-channel at column D."""
    jp, jpack, tp, tpack, feats, _, _ = views(tile)
    ref = np.asarray(adjoint_pallas_raw(
        jpack, jnp.asarray(feats), jp, interpret=True, out_dtype=jnp.float32,
        d_chunk=128, feat_cols=D, mxu_prefix=False))[: tp.T_padded, : D + 1]
    rows = adjoint_rows(tpack, torch.from_numpy(feats), tp)
    assert rows.shape == (tp.T_padded, contrib_width(D)) == (tp.T_padded, 128)
    assert not rows[:, D + 1:].any()
    _within(rows[:, : D + 1].numpy(), ref, 1e-4, "rows")


@pytest.mark.parametrize("tile", [16, 32])
def test_adjoint_bf16_within_budget_of_exact(views, tile):
    jp, jpack, tp, tpack, feats, fs, ws = views(tile)
    num, den = backproject_view(tpack, torch.from_numpy(feats).to(torch.bfloat16), tp)
    _within(den.numpy(), ws, 5e-3, "den")
    _within(num.numpy(), fs, 1e-2, "num")


def _twin_rows(views, tile):
    _, _, tp, tpack, feats, _, _ = views(tile)
    return adjoint_rows(tpack, torch.from_numpy(feats), tp)


@pytest.mark.parametrize("tile", [16, 32])
def test_rows_error_sees_a_dropped_product_on_the_lightest_row(views, tile):
    """A row whose weight is tiny next to the heaviest row passes any test
    against the largest value; rows_error holds each row to its own."""
    ref = _twin_rows(views, tile)
    weight = ref[:, D].clone()
    weight[weight < torch.finfo(torch.float32).tiny] = float("inf")
    light = int(torch.argmin(weight))
    got = ref.clone()
    got[light, :D] = 0
    assert float(ref[light, D]) < 1e-2 * float(ref[:, D].max())
    _, _, of_row = rows_error(got, ref, D)
    assert of_row == 1.0 > ROWS_TOL[torch.bfloat16][1]


@pytest.mark.parametrize("tile", [16, 32])
def test_rows_error_passes_one_bf16_ulp(views, tile):
    """Every nonzero value one bf16 unit in the last place away stays
    within the bf16 limits; zero rows stay exact."""
    ref = _twin_rows(views, tile).to(torch.bfloat16)
    bits = ref.view(torch.int16)
    got = torch.where(ref != 0, bits + 1, bits).view(torch.bfloat16)
    _, of_group, of_row = rows_error(got, ref, D)
    group_tol, row_tol = ROWS_TOL[torch.bfloat16]
    assert 0 < of_group <= 2**-7 < group_tol
    assert 0 < of_row <= 2**-7 < row_tol


@pytest.mark.parametrize("tile", [16, 32])
def test_rows_error_sees_a_row_that_should_be_zero(views, tile):
    ref = _twin_rows(views, tile)
    zero = int(torch.nonzero((ref == 0).all(1))[0])
    got = ref.clone()
    got[zero, :D] = 1e-6
    abs_err, _, of_row = rows_error(got, ref, D)
    assert abs_err == pytest.approx(1e-6) and of_row == 1.0


@pytest.mark.parametrize("tile", [16, 32])
def test_rows_error_ignores_subnormal_rows(views, tile):
    """Rows of weights below the smallest normal float (pixels whose T has
    all but vanished) are held to that float, not to themselves."""
    ref = _twin_rows(views, tile)
    ref[0] = 1e-43
    got = ref.clone()
    got[0, 0] = 1e-43 + 1.4e-45  # one subnormal step: 1.4% of the value
    _, _, of_row = rows_error(got, ref, D)
    assert of_row <= 1e-6


@pytest.mark.parametrize("slices, cluster, grid_x", [
    (1, 1, 1), (2, 2, 2), (5, 5, 5), (8, 8, 8), (9, 5, 10), (17, 6, 18)])
def test_adjoint_cluster_geometry(slices, cluster, grid_x):
    """B2's clusters: C = ceil(S / ceil(S / 8)) CTAs, one per channel slice,
    ceil(S / 8) clusters per tile; every slice has a CTA, at most C - 1
    CTAs have none, and no cluster exceeds the portable size."""
    c, gx = adjoint_cluster(slices * CHANNEL_SLICE)
    assert (c, gx) == (cluster, grid_x)
    assert c <= MAX_CLUSTER and gx % c == 0 and slices <= gx < slices + c


@pytest.mark.parametrize("width", [0, 100, 129])
def test_adjoint_cluster_refuses_a_ragged_width(width):
    with pytest.raises(ValueError):
        adjoint_cluster(width)
