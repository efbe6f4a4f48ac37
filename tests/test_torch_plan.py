"""The port's per-view plan against tpugs' ``_plan_build`` (through
``build_plan_pure`` with ``estimate_sizes_pallas`` sizes): exact integers.

tpugs sizes its buffers with static buckets (T_padded rounded up, slot
table with caps); the port sizes them exactly, so the reference's arrays
are compared on the port's extent and their padding is checked to be
padding. Exact equality assumes no depth ties and no cull decision within
an ulp of its threshold, which these random scenes do not have."""

import numpy as np
import pytest

from tpugs.lift.pallas_batch import estimate_sizes_pallas
from tpugs.raster.pallas_tiled import build_plan_pure
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import SCENE_FIELDS, cameras_from_numpy, scene_from_numpy
from tpugs_torch.raster.plan import BLOCK, build_plan
from tpugs_torch.raster.projection import project

W, H, N = 160, 96, 500


@pytest.fixture(scope="module")
def plans():
    js = random_scene(N, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(2, W, H, radius=2.5)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                          device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    sizes = {t: estimate_sizes_pallas(js, jc, tile_size=t) for t in (16, 32)}
    cache = {}

    def get(cam, tile):
        if (cam, tile) not in cache:
            jp = build_plan_pure(js.means, js.quats, js.scales, js.opacities,
                                 jc.viewmats[cam], jc.Ks[cam], W, H, sizes[tile],
                                 tile_size=tile)
            proj = project(ts.means, ts.quats, ts.scales, ts.opacities,
                           tc.viewmats[cam], tc.Ks[cam], W, H)
            cache[cam, tile] = (jp, build_plan(proj, W, H, tile))
        return cache[cam, tile]

    return get


CASES = [(cam, tile) for cam in (0, 1) for tile in (16, 32)]


@pytest.mark.parametrize("cam,tile", CASES)
def test_plan_spans_match(plans, cam, tile):
    jp, tp = plans(cam, tile)
    for name in ("tile_starts", "tile_ends", "padded_starts"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)
    np.testing.assert_array_equal(tp.order.numpy(), np.asarray(jp.order))
    gid = np.asarray(jp.padded_gid)
    assert tp.T_padded % BLOCK == 0 and tp.T_padded <= jp.T_padded
    np.testing.assert_array_equal(tp.padded_gid.numpy(), gid[: tp.T_padded])
    assert (gid[tp.T_padded:] == N).all(), "reference slots past the exact size are padding"
    assert tp.n_isects == int((tp.tile_ends - tp.tile_starts).sum()) > 0


@pytest.mark.parametrize("cam,tile", CASES)
def test_position_lists_match_slot_table(plans, cam, tile):
    """Each Gaussian's positions, in order, equal the real entries of its
    column of the reference's cover-major slot table."""
    jp, tp = plans(cam, tile)
    slots = np.asarray(jp.slots)  # (cover_pad, N)
    slot_order = np.asarray(jp.slot_order)
    off = tp.gauss_offsets.numpy()
    pos = tp.gauss_pos.numpy()
    n_real = 0
    for col in range(N):
        g = slot_order[col]
        ref = slots[:, col]
        ref = ref[ref < jp.T_padded]
        np.testing.assert_array_equal(pos[off[g]:off[g + 1]], ref, err_msg=f"Gaussian {g}")
        n_real += len(ref)
    assert n_real == tp.n_isects == len(pos)
