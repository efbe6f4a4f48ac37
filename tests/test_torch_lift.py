"""The whole slice: the port's ``backproject_views`` against tpugs'
``backproject_views_grouped`` (Pallas in interpret mode, f32 contribution
rows: the exact path) on 3 views of one numpy-seeded scene, the linear
encoder at D = 24, tile 32, 160x96.

* port f32 against it: 1e-4 x max|ref| (matmul summation order);
* port bf16 against the same f32 result: den 0.5%, num 1% of max;
* ``normalize_field`` on the same inputs: 1e-6, and on each package's
  own sums where the weight is not vanishing: 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.encoders.base import LinearRGBEncoder as JLinearRGBEncoder
from tpugs.lift.batch import normalize_field as j_normalize_field
from tpugs.lift.pallas_batch import backproject_views_grouped, estimate_sizes_pallas
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import (
    SCENE_FIELDS,
    cameras_from_numpy,
    linear_encoder_from_numpy,
    scene_from_numpy,
)
from tpugs_torch.lift.batch import backproject_views, normalize_field

W, H, D, TILE, VIEWS = 160, 96, 24, 32, 3


@pytest.fixture(scope="module")
def lifted():
    js = random_scene(500, seed=2, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(VIEWS, W, H, radius=2.5)
    jenc = JLinearRGBEncoder(D, seed=1)
    sizes = estimate_sizes_pallas(js, jc, tile_size=TILE)
    num_j, den_j = backproject_views_grouped(
        js, jc.viewmats, jc.Ks, W, H, jenc, sizes, group_size=VIEWS, interpret=True,
        tile_size=TILE, contrib_dtype=jnp.float32)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                          device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    tenc = linear_encoder_from_numpy(np.asarray(jenc._proj), device="cpu")

    def port(dtype):
        return backproject_views(ts, tc.viewmats, tc.Ks, W, H, tenc, tile_size=TILE,
                                 contrib_dtype=dtype, device="cpu")

    return np.array(num_j), np.array(den_j), port


def _within(got, ref, frac, what):
    scale = float(np.abs(ref).max())
    assert scale > 0
    err = float(np.abs(got - ref).max())
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


def test_lift_f32_matches_grouped(lifted):
    num_j, den_j, port = lifted
    num, den = port(torch.float32)
    assert num.shape == num_j.shape and den.shape == den_j.shape
    assert num.dtype == den.dtype == torch.float32
    _within(den.numpy(), den_j, 1e-4, "den")
    _within(num.numpy(), num_j, 1e-4, "num")
    assert (den_j > 0).mean() > 0.3


def test_lift_bf16_within_budget_of_exact(lifted):
    num_j, den_j, port = lifted
    num, den = port(torch.bfloat16)
    _within(den.numpy(), den_j, 5e-3, "den")
    _within(num.numpy(), num_j, 1e-2, "num")


def test_normalize_field_matches(lifted):
    num_j, den_j, port = lifted
    same = normalize_field(torch.from_numpy(num_j), torch.from_numpy(den_j)).numpy()
    np.testing.assert_allclose(same, np.asarray(j_normalize_field(num_j, den_j)),
                               atol=1e-6)
    num, den = port(torch.float32)
    field = normalize_field(num, den).numpy()
    lit = den_j > 1e-3 * den_j.max()
    np.testing.assert_allclose(field[lit], same[lit], atol=1e-4)
    np.testing.assert_array_equal(field[den.numpy() == 0], 0.0)


def test_spatial_encoder_view_matches():
    """A non-pixelwise encoder runs on the (H, W, 3) image and its features
    go back to the tile layout (``image_to_tiles``)."""
    from tpugs.encoders.base import PatchAverageEncoder as JPatch
    from tpugs.lift.pallas_batch import backproject_one_view_pallas
    from tpugs_torch.encoders.base import PatchAverageEncoder
    from tpugs_torch.lift.batch import backproject_one_view

    js = random_scene(300, seed=5, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(1, 150, 90, radius=2.5)
    sizes = estimate_sizes_pallas(js, jc, tile_size=TILE)
    jenc = JPatch(JLinearRGBEncoder(8, seed=4), patch=8)
    fs, ws = backproject_one_view_pallas(
        js, jc.viewmats[0], jc.Ks[0], 150, 90, jenc, sizes, d_chunk=128, interpret=True,
        tile_size=TILE, contrib_dtype=jnp.float32)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                          device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), 150, 90,
                            device="cpu")
    tenc = PatchAverageEncoder(linear_encoder_from_numpy(np.asarray(jenc.inner._proj),
                                                         device="cpu"), patch=8)
    num, den = backproject_one_view(ts, tc.viewmats[0], tc.Ks[0], 150, 90, tenc,
                                    tile_size=TILE, contrib_dtype=torch.float32)
    _within(den.numpy(), np.asarray(ws), 1e-4, "den")
    _within(num.numpy(), np.asarray(fs), 1e-4, "num")
