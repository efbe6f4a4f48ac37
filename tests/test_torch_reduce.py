"""B3's plain twin against tpugs' ``reduce_contribs_pallas`` (Pallas in
interpret mode) on tpugs' own B2 output rows: bit-equal, because both add
each Gaussian's rows in f32 from 0 in increasing tile order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.lift.pallas_batch import estimate_sizes_pallas
from tpugs.raster.pallas_tiled import adjoint_pallas_raw, build_plan_pure
from tpugs.raster.pallas_tiled import pack_isect_all as j_pack
from tpugs.raster.pallas_tiled import reduce_contribs_pallas
from tpugs.raster.projection import project as j_project
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import SCENE_FIELDS, cameras_from_numpy, scene_from_numpy
from tpugs_torch.raster.kernels import reduce_rows
from tpugs_torch.raster.plan import build_plan
from tpugs_torch.raster.projection import project

W, H, D = 64, 48, 20


@pytest.fixture(scope="module")
def setup():
    js = random_scene(600, seed=0, extent=1.0, scale_range=(0.08, 0.25))
    jc = orbit_cameras(2, W, H, radius=1.8)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                          device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    return js, jc, ts, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [16, 32])
def test_reduce_twin_bit_equal_to_pallas(setup, tile, dtype):
    js, jc, ts, tc = setup
    cam = 1
    jargs = (js.means, js.quats, js.scales, js.opacities)
    sizes = estimate_sizes_pallas(js, jc, tile_size=tile)
    jp = build_plan_pure(*jargs, jc.viewmats[cam], jc.Ks[cam], W, H, sizes, tile_size=tile)
    jpack = j_pack(j_project(*jargs, jc.viewmats[cam], jc.Ks[cam], W, H), None, jp)
    n_tiles = jp.tile_starts.shape[0]
    feats = np.random.default_rng(5).normal(size=(n_tiles, tile * tile, D))
    jdt = getattr(jnp, dtype)
    contribs = adjoint_pallas_raw(jpack, jnp.asarray(feats, jdt), jp, interpret=True,
                                  out_dtype=jdt, d_chunk=128, feat_cols=D)
    ref = np.asarray(reduce_contribs_pallas(contribs, jp, interpret=True))

    tp = build_plan(project(ts.means, ts.quats, ts.scales, ts.opacities,
                            tc.viewmats[cam], tc.Ks[cam], W, H), W, H, tile)
    # the same rows, on the port's exact extent (bf16 values pass through
    # f32 exactly)
    rows = torch.from_numpy(np.array(contribs.astype(jnp.float32))[: tp.T_padded])
    rows = rows.to(getattr(torch, dtype)).contiguous()
    got = reduce_rows(rows, tp, 128)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.abs(ref[:, D]).max() > 0
