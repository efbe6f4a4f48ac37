"""The XLA reduce engine (``reduce_engine="xla"``, ``raster/reduce.py``).

* the port's ``backproject_views(..., reduce_engine="xla")`` against tpugs'
  ``backproject_views_grouped(..., reduce_engine="xla")`` (Pallas in
  interpret mode, f32 rows) on 3 views of one numpy-seeded scene of 200
  Gaussians at 96x64, tile 32, the linear encoder at D = 24: 1e-4 of
  max|ref| (matmul summation order), as ``test_torch_lift.py`` holds the
  default engine;
* its sums against B3's (the "pallas" engine, ``reduce_rows``) on the same
  rows, f32 and bf16: 1e-6 of max (float rounding of another sum order),
  also with the gather groups cut to 64 rows;
* no engine outside ``REDUCE_ENGINES`` is taken.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.encoders.base import LinearRGBEncoder as JLinearRGBEncoder
from tpugs.lift.pallas_batch import backproject_views_grouped, estimate_sizes_pallas
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import (
    SCENE_FIELDS,
    cameras_from_numpy,
    linear_encoder_from_numpy,
    scene_from_numpy,
)
from tpugs_torch.lift.batch import backproject_views, run_view
from tpugs_torch.raster import reduce as R
from tpugs_torch.raster.kernels import reduce_rows
from tpugs_torch.raster.tiled import REDUCE_ENGINES, contribution_sums

W, H, D, TILE, VIEWS = 96, 64, 24, 32, 3


@pytest.fixture(scope="module")
def scene():
    js = random_scene(200, seed=2, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(VIEWS, W, H, radius=2.5)
    jenc = JLinearRGBEncoder(D, seed=1)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                          device="cpu")
    tc = cameras_from_numpy(np.array(jc.viewmats), np.array(jc.Ks), W, H, device="cpu")
    tenc = linear_encoder_from_numpy(np.array(jenc._proj), device="cpu")
    return js, jc, jenc, ts, tc, tenc


def _within(got, ref, frac, what):
    scale = float(np.abs(ref).max())
    assert scale > 0
    err = float(np.abs(got - ref).max())
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


def test_xla_engine_matches_tpugs(scene):
    js, jc, jenc, ts, tc, tenc = scene
    sizes = estimate_sizes_pallas(js, jc, tile_size=TILE)
    num_j, den_j = backproject_views_grouped(
        js, jc.viewmats, jc.Ks, W, H, jenc, sizes, group_size=VIEWS, interpret=True,
        tile_size=TILE, contrib_dtype=jnp.float32, reduce_engine="xla")
    num, den = backproject_views(ts, tc.viewmats, tc.Ks, W, H, tenc, tile_size=TILE,
                                 contrib_dtype=torch.float32, device="cpu",
                                 reduce_engine="xla")
    _within(den.numpy(), np.asarray(den_j), 1e-4, "den")
    _within(num.numpy(), np.asarray(num_j), 1e-4, "num")
    assert (np.asarray(den_j) > 0).mean() > 0.3


@pytest.mark.parametrize("max_rows", [R.MAX_ROWS, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xla_sums_equal_b3s(scene, dtype, max_rows, monkeypatch):
    _, _, _, ts, tc, tenc = scene
    monkeypatch.setattr(R, "MAX_ROWS", max_rows)
    r = run_view(ts, tc.viewmats[0], tc.Ks[0], W, H, tenc, TILE, contrib_dtype=dtype)
    culled = (r.plan.gauss_offsets[1:] - r.plan.gauss_offsets[:-1])
    assert int(culled.max()) >= 3  # several cover rows, caps that fall
    ref = reduce_rows(r.rows, r.plan, D + 1)
    got = R.reduce_contribs_xla(r.rows, r.plan, D + 1)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    _within(got.numpy(), ref.numpy(), 1e-6, f"{dtype} sums")
    rows, sums = contribution_sums(r.packed, r.feat_tiles, r.plan, reduce_engine="xla")
    assert torch.equal(rows, r.rows) and torch.equal(sums, got)


def test_unknown_engine_raises(scene):
    _, _, _, ts, tc, tenc = scene
    assert REDUCE_ENGINES == ("pallas", "scatter", "xla")
    r = run_view(ts, tc.viewmats[0], tc.Ks[0], W, H, tenc, TILE)
    with pytest.raises(ValueError):
        contribution_sums(r.packed, r.feat_tiles, r.plan, reduce_engine="atomic")
