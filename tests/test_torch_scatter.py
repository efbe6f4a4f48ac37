"""The opt-in scatter reduce engine of the port (plan extras, B6's and
B7's twins, ``reduce_engine="scatter"``) against tpugs and against the
port's default engine, on the CPU.

* plan extras: exact integers (every real intersection has one live
  striped row, padding goes to the trash row, caps never increase);
* ``culled`` per original Gaussian equals tpugs' ``plan.culled`` mapped
  back through its ``slot_order``, on the plan of tpugs' own scatter test
  (in-cap buckets, ``probe_stride=1``): exact;
* twins: B6's, gathered by ``slot_pos``, bit-equal to B2's; B7's bit-equal
  to B3's, with the NaN fill of unwritten striped rows never reaching a
  sum;
* the whole path against tpugs' ``backproject_views_grouped(
  reduce_engine="scatter")`` (Pallas in interpret mode, f32 rows): 1e-4 x
  max|ref|, as ``test_torch_lift.py`` (matmul summation order); against the
  port's default engine: bit-equal in f32 and bf16;
* refusals: unknown engines raise (names are case-sensitive); "xla", once
  refused, is ported (``raster/reduce.py``) and gives B3's sums to 1e-6 of
  max.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.encoders.base import LinearRGBEncoder as JLinearRGBEncoder
from tpugs.lift.pallas_batch import backproject_views_grouped, estimate_sizes_pallas
from tpugs.raster.pallas_tiled import build_plan_pure
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import (
    SCENE_FIELDS,
    cameras_from_numpy,
    linear_encoder_from_numpy,
    scene_from_numpy,
)
from tpugs_torch.encoders.base import LinearRGBEncoder
from tpugs_torch.lift.batch import backproject_one_view, backproject_views, run_view
from tpugs_torch.raster import kernels as K
from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.pack import pack_isect_all
from tpugs_torch.raster.plan import BLOCK, build_plan, scatter_columns, with_scatter_extras
from tpugs_torch.raster.projection import project
from tpugs_torch.raster.tiled import contribution_sums

W, H, N, D = 160, 96, 500, 24


def _port_scene(js):
    return scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                            device="cpu")


@pytest.fixture(scope="module")
def views():
    js = random_scene(N, seed=0, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(2, W, H, radius=2.5)
    ts = _port_scene(js)
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    cache = {}

    def get(cam, tile):
        if (cam, tile) not in cache:
            vm, Km = tc.viewmats[cam], tc.Ks[cam]
            proj = project(ts.means, ts.quats, ts.scales, ts.opacities, vm, Km, W, H)
            plan = build_plan(proj, W, H, tile, scatter=True)
            pack = pack_isect_all(
                proj, prepare_colors(ts.means, ts.colors_all, vm, ts.sh_degree), plan)
            feats = torch.from_numpy(np.random.default_rng(cam + tile).normal(
                size=(plan.n_tiles, tile * tile, D)).astype(np.float32))
            cache[cam, tile] = (proj, plan, pack, feats)
        return cache[cam, tile]

    return get


CASES = [(cam, tile) for cam in (0, 1) for tile in (16, 32)]


@pytest.mark.parametrize("cam,tile", CASES)
def test_every_intersection_has_one_live_striped_row(views, cam, tile):
    _, plan, _, _ = views(cam, tile)
    real = plan.gauss_pos.long()
    live = plan.slot_pos.long()[real]
    assert plan.n_isects > 0
    assert torch.unique(live).shape[0] == plan.n_isects, "two entries share a striped row"
    assert (live < plan.R_striped).all()
    # the striped row of column c's j-th entry is stripe_base[j] + c
    off = plan.gauss_offsets.long()
    column = scatter_columns(plan)
    assert torch.equal(plan.slot_order[column], torch.arange(N))
    owner = torch.repeat_interleave(torch.arange(N), off[1:] - off[:-1])
    j = torch.arange(plan.n_isects) - off[owner]
    assert torch.equal(live[torch.arange(plan.n_isects)],
                       plan.stripe_base.long()[j] + column[owner])
    assert (j < plan.culled.long()[column[owner]]).all()


@pytest.mark.parametrize("cam,tile", CASES)
def test_padding_slots_go_to_the_trash_row(views, cam, tile):
    _, plan, _, _ = views(cam, tile)
    is_real = torch.zeros(plan.T_padded, dtype=torch.bool)
    is_real[plan.gauss_pos.long()] = True
    assert torch.equal(is_real, plan.padded_gid < N)
    assert (plan.slot_pos[~is_real] == plan.R_striped).all()
    assert plan.slot_pos.dtype == torch.int32 and plan.slot_pos.shape == (plan.T_padded,)


@pytest.mark.parametrize("cam,tile", CASES)
def test_caps_never_increase_and_stripes_are_block_padded(views, cam, tile):
    _, plan, _, _ = views(cam, tile)
    culled = plan.culled.long()
    off = plan.gauss_offsets.long()
    assert torch.equal(culled, (off[1:] - off[:-1])[plan.slot_order])
    assert torch.equal(plan.slot_order, torch.sort(-(off[1:] - off[:-1]), stable=True).indices)
    n_stripes = int(culled.max())
    assert plan.stripe_base.shape == (n_stripes,)
    caps = torch.stack([(culled > j).sum() for j in range(n_stripes)])
    assert (caps[1:] <= caps[:-1]).all() and int(caps[0]) > 0
    # the live columns of stripe j are exactly its first cap[j]
    for j in range(n_stripes):
        assert (culled[: int(caps[j])] > j).all() and not (culled[int(caps[j]):] > j).any()
    padded = (caps + BLOCK - 1) // BLOCK * BLOCK
    assert torch.equal(plan.stripe_base.long(), torch.cumsum(padded, 0) - padded)
    assert plan.R_striped == int(padded.sum())


@pytest.mark.parametrize("cam,tile", CASES)
def test_scatter_plan_keeps_the_default_plan(views, cam, tile):
    proj, plan, _, _ = views(cam, tile)
    plain = build_plan(proj, W, H, tile)
    assert plain.slot_pos is None and plain.culled is None and plain.R_striped == 0
    extras = {"slot_order", "culled", "stripe_base", "slot_pos", "R_striped"}
    for f in dataclasses.fields(plain):
        if f.name in extras:
            continue
        a, b = getattr(plain, f.name), getattr(plan, f.name)
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        assert same, f.name
    assert torch.equal(with_scatter_extras(plain).slot_pos, plan.slot_pos)


# tpugs' own scatter test's plan (tests/test_pallas.py:711-714): in-cap buckets
@pytest.fixture(scope="module")
def reference_plans():
    js = random_scene(400, seed=7, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(2, 160, 96, radius=2.5)
    ts = _port_scene(js)
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), 160, 96, device="cpu")

    def get(cam, tile):
        sizes = estimate_sizes_pallas(js, jc, probe_stride=1, tile_size=tile)
        jp = build_plan_pure(js.means, js.quats, js.scales, js.opacities, jc.viewmats[cam],
                             jc.Ks[cam], 160, 96, sizes, tile_size=tile, scatter=True)
        proj = project(ts.means, ts.quats, ts.scales, ts.opacities, tc.viewmats[cam],
                       tc.Ks[cam], 160, 96)
        return jp, build_plan(proj, 160, 96, tile, scatter=True)

    return get


@pytest.mark.parametrize("cam,tile", CASES)
def test_culled_per_gaussian_matches_tpugs(reference_plans, cam, tile):
    jp, tp = reference_plans(cam, tile)
    ref = np.zeros(400, np.int64)
    ref[np.asarray(jp.slot_order)] = np.asarray(jp.culled)
    got = np.zeros(400, np.int64)
    got[tp.slot_order.numpy()] = tp.culled.numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.max() > 1


TWIN_CASES = [(tile, dtype) for tile in (16, 32) for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("tile,dtype", TWIN_CASES)
def test_b6_twin_through_slot_pos_is_b2_twin(views, tile, dtype):
    _, plan, pack, feats = views(1, tile)
    f = feats.to(dtype)
    rows = K.adjoint_rows(pack, f, plan)
    striped = K.adjoint_scatter_rows(pack, f, plan)
    assert striped.shape == (plan.R_striped + 1, rows.shape[1]) and striped.dtype == dtype
    real = plan.gauss_pos.long()
    assert torch.equal(striped[plan.slot_pos.long()[real]], rows[real])
    # every striped row but the live ones and the trash row is the NaN fill
    written = torch.zeros(plan.R_striped + 1, dtype=torch.bool)
    written[plan.slot_pos.long()] = True
    assert plan.T_padded > plan.n_isects and written.sum() == plan.n_isects + 1
    assert torch.isnan(striped[~written].float()).all() and (~written).any()


@pytest.mark.parametrize("tile,dtype", TWIN_CASES)
def test_b7_twin_is_b3_twin_and_never_reads_the_fill(views, tile, dtype):
    _, plan, pack, feats = views(0, tile)
    f = feats.to(dtype)
    striped = K.adjoint_scatter_rows(pack, f, plan)
    sums = K.reduce_striped(striped, plan, D + 1)
    assert sums.dtype == torch.float32 and sums.shape == (N, D + 1)
    assert torch.isfinite(sums).all()
    assert torch.equal(sums, K.reduce_rows(K.adjoint_rows(pack, f, plan), plan, D + 1))
    assert float(sums[:, D].abs().max()) > 0


@pytest.mark.parametrize("tile", [16, 32])
def test_b7_twin_column_order_and_sampled_gaussians(views, tile):
    _, plan, pack, feats = views(0, tile)
    striped = K.adjoint_scatter_rows(pack, feats, plan)
    sums = K.reduce_striped(striped, plan, D + 1)
    cols = K.reduce_striped(striped, plan, D + 1, unpermute=False)
    assert torch.equal(cols, sums[plan.slot_order])
    gids = torch.tensor([7, 3, 499, 0, 250])
    assert torch.equal(K.reduce_striped_plain(striped, plan, D + 1, gaussians=gids), sums[gids])


@pytest.fixture(scope="module")
def lifted():
    js = random_scene(300, seed=2, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(2, W, H, radius=2.5)
    jenc = JLinearRGBEncoder(D, seed=1)
    sizes = estimate_sizes_pallas(js, jc, probe_stride=1, tile_size=32)
    num_j, den_j = backproject_views_grouped(
        js, jc.viewmats, jc.Ks, W, H, jenc, sizes, group_size=2, interpret=True,
        tile_size=32, contrib_dtype=jnp.float32, reduce_engine="scatter")
    ts = _port_scene(js)
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), W, H, device="cpu")
    tenc = linear_encoder_from_numpy(np.asarray(jenc._proj), device="cpu")

    def port(dtype, engine):
        return backproject_views(ts, tc.viewmats, tc.Ks, W, H, tenc, tile_size=32,
                                 contrib_dtype=dtype, device="cpu", reduce_engine=engine)

    return np.array(num_j), np.array(den_j), port


def test_scatter_engine_matches_tpugs_scatter_engine(lifted):
    num_j, den_j, port = lifted
    num, den = port(torch.float32, "scatter")
    for got, ref, what in ((den.numpy(), den_j, "den"), (num.numpy(), num_j, "num")):
        scale = float(np.abs(ref).max())
        assert scale > 0
        err = float(np.abs(got - ref).max())
        assert err <= 1e-4 * scale, f"{what}: {err:.3e} > 1e-4 x {scale:.3e}"
    assert (den_j > 0).mean() > 0.3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_engine_bit_equal_to_default_engine(lifted, dtype):
    _, _, port = lifted
    num_s, den_s = port(dtype, "scatter")
    num, den = port(dtype, "pallas")
    assert torch.equal(num_s, num) and torch.equal(den_s, den)


def test_run_view_keeps_the_striped_buffer():
    ts = _port_scene(random_scene(200, seed=4, extent=0.8, scale_range=(0.02, 0.1)))
    jc = orbit_cameras(1, 96, 64, radius=2.5)
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), 96, 64, device="cpu")
    enc = LinearRGBEncoder(8, seed=0, device="cpu")
    r = run_view(ts, tc.viewmats[0], tc.Ks[0], 96, 64, enc, 16, reduce_engine="scatter")
    d = run_view(ts, tc.viewmats[0], tc.Ks[0], 96, 64, enc, 16)
    assert r.plan.slot_pos is not None and d.plan.slot_pos is None
    assert r.rows.shape == (r.plan.R_striped + 1, 128) and d.rows.shape == (d.plan.T_padded, 128)
    assert torch.equal(r.sums, d.sums)


REFUSED = {
    "XLA": ValueError,
    "bogus": ValueError,
    "Scatter": ValueError,
}


@pytest.mark.parametrize("engine", sorted(REFUSED))
def test_engines_the_port_lacks_raise(views, engine):
    _, plan, pack, feats = views(0, 16)
    exc = REFUSED[engine]
    with pytest.raises(exc):
        contribution_sums(pack, feats, plan, reduce_engine=engine)
    scene = random_scene(10, seed=0)
    with pytest.raises(exc):
        backproject_one_view(_port_scene(scene), torch.eye(4), torch.eye(3), 32, 32,
                             LinearRGBEncoder(4, device="cpu"), reduce_engine=engine)
    with pytest.raises(exc):
        backproject_views(_port_scene(scene), torch.eye(4)[None], torch.eye(3)[None], 32, 32,
                          LinearRGBEncoder(4, device="cpu"), device="cpu",
                          reduce_engine=engine)


def test_xla_refusal_points_to_the_roadmap(views):
    """The XLA engine is no longer refused: it runs, and the refusal of an
    unknown engine names it among the engines the port has."""
    _, plan, pack, feats = views(0, 16)
    _, ref = contribution_sums(pack, feats, plan)
    _, got = contribution_sums(pack, feats, plan, reduce_engine="xla")
    scale = float(ref.abs().max())
    assert scale > 0 and float((got - ref).abs().max()) <= 1e-6 * scale
    with pytest.raises(ValueError, match="xla"):
        contribution_sums(pack, feats, plan, reduce_engine="bogus")
