"""Tiles other than 16 and 32, and widths past the card's B5 cap, on the
CPU: the port's twins against tpugs (Pallas in interpret mode) on the
same numpy-seeded inputs, the kernels' pixel layouts at tiles 1 to 64, 96
and 128, and the exit vote's twin.

* ``backproject_views`` (f32 rows) against ``backproject_views_grouped``
  at tiles 8 and 12: 1e-4 of max|ref|, as ``test_torch_lift.py``;
* ``render_plan_train`` with a background and the absgrad probe against
  tpugs' at tiles 8 and 12, ``trans_eps`` 1e-4, D = 5 and 300, and at tile
  48 (pixel groups and the exit vote on the card), D = 5: image and
  alpha 1e-5 of max|ref|, every gradient 3e-4 of its max, as
  ``test_torch_train_render.py``; at tile 8 both packages run twice and
  give the same bits each time;
* ``render_tiled`` with the absgrad probe at D = 4097 (past 4096, the
  card's old cap) against ``render_tiled_autodiff`` on a 20-Gaussian 32x32
  scene, the probe against autograd with a leaf copy of each mean per
  pixel: 5e-5 of each max, as ``test_torch_api.py``;
* for every tile 1 to 64, 96 and 128 and widths up to
  ``GEOM_MAX_CHANNELS``: B1's warp rectangles, B2's pixel groups, B4's
  and B5's ranks (cluster kernel and colour slices) and B5's geometry
  kernel's ranks, in their pixel groups, as the kernels map their slots to
  pixels, cover each pixel of the tile exactly once; the ghost slots are
  fewer than one CTA's a pixel group (B1: beyond the rectangles' rounding),
  one group's (B2) or one rank's a pixel group (B4, B5), every pixel group
  holds a pixel, and the exit vote's groups (``render_groups``,
  ``train_fwd_groups``) are those of the slots;
* ``exit_vote_plain`` at tiles 33, 48 and 64, on a one-tile scene whose
  bottom rows (one pixel group of B1 and of B4) see only faint Gaussians
  while opaque ones cover the rest: the planted group exits blocks after
  every other, and the largest of the groups' exits is the whole-tile
  twins' ``blocks_done`` (B1's and B4's);
* every layout refuses tile 0 and takes tile 33.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.encoders.base import LinearRGBEncoder as JLinearRGBEncoder
from tpugs.lift.pallas_batch import backproject_views_grouped, estimate_sizes_pallas
from tpugs.raster.pallas_tiled import build_pallas_plan
from tpugs.raster.pallas_train import render_plan_train as j_render_plan_train
from tpugs.raster.projection import project as j_project
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.convert import (
    SCENE_FIELDS,
    cameras_from_numpy,
    linear_encoder_from_numpy,
    scene_from_numpy,
)
from tpugs_torch.lift.batch import backproject_views
from tpugs_torch.raster import kernels as K
from tpugs_torch.raster import train as T
from tpugs_torch.raster.kernels import _tile_pixels
from tpugs_torch.raster.naive import evaluate_alpha
from tpugs_torch.raster.pack import pack_isect_all
from tpugs_torch.raster.plan import build_plan
from tpugs_torch.raster.projection import Projected, project
from tpugs_torch.raster.tiled import TileConfig, render_tiled, render_tiled_autodiff
from tpugs_torch.raster.tiles import tiles_to_image

NAMES = ("means2d", "conics", "opacities", "colors", "background", "absgrad")


def _within(got, ref, frac, what):
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    err = float(np.abs(got - ref).max())
    assert err <= frac * scale + 1e-8, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


# ------------------------------------------------------------- the lift


@pytest.mark.parametrize("tile", [8, 12])
def test_lift_matches_grouped_at_other_tiles(tile):
    w, h, d, views = 48, 40, 12, 1
    js = random_scene(150, seed=2, extent=0.8, scale_range=(0.02, 0.1))
    jc = orbit_cameras(views, w, h, radius=2.5)
    jenc = JLinearRGBEncoder(d, seed=1)
    sizes = estimate_sizes_pallas(js, jc, tile_size=tile)
    num_j, den_j = backproject_views_grouped(
        js, jc.viewmats, jc.Ks, w, h, jenc, sizes, group_size=views, interpret=True,
        tile_size=tile, contrib_dtype=jnp.float32)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}, device="cpu")
    tc = cameras_from_numpy(np.asarray(jc.viewmats), np.asarray(jc.Ks), w, h, device="cpu")
    tenc = linear_encoder_from_numpy(np.asarray(jenc._proj), device="cpu")
    num, den = backproject_views(ts, tc.viewmats, tc.Ks, w, h, tenc, tile_size=tile,
                                 contrib_dtype=torch.float32, device="cpu")
    num_j, den_j = np.array(num_j), np.array(den_j)
    assert (den_j > 0).mean() > 0.3
    _within(den.numpy(), den_j, 1e-4, "den")
    _within(num.numpy(), num_j, 1e-4, "num")


# ------------------------------------------- the train render, with gradients

W, H, N = 64, 48, 600


def _train_inputs(d, tile):
    js = random_scene(N, seed=0, extent=1.0, scale_range=(0.08, 0.25))
    jc = orbit_cameras(2, W, H, radius=2.5)
    vm, Km = jc.viewmats[0], jc.Ks[0]
    jproj = j_project(js.means, js.quats, js.scales, js.opacities, vm, Km, W, H)
    opac = np.asarray(jnp.where(jproj.valid, jproj.opacities, 0.0))
    rng = np.random.default_rng(100 + d)
    colors = rng.uniform(0, 1, (N, d)).astype(np.float32)
    bg = rng.uniform(0, 1, (d,)).astype(np.float32)
    r = rng.normal(0, 1, (H, W, d)).astype(np.float32)
    s = rng.normal(0, 1, (H, W)).astype(np.float32)
    jplan = build_pallas_plan(js.means, js.quats, js.scales, js.opacities, vm, Km, W, H,
                              tile_size=tile)
    tplan = build_plan(Projected(*(torch.from_numpy(np.array(f)) for f in jproj)), W, H, tile)
    arrays = [np.asarray(jproj.means2d), np.asarray(jproj.conics), opac, colors, bg]
    return arrays, r, s, jplan, tplan


def _reference(arrays, r, s, jplan, runs=1):
    """tpugs' image, alpha and gradients, from ``runs`` runs of one
    compiled program."""
    def loss(m2d, con, op, cols, bg, probe):
        img, alpha = j_render_plan_train(m2d, con, op, cols, jplan, background=bg,
                                         interpret=True, trans_eps=1e-4, abs_probe=probe)
        return jnp.sum(img * r) + jnp.sum(alpha * s), (img, alpha)

    args = [jnp.asarray(a) for a in arrays] + [jnp.zeros((N, 2), jnp.float32)]
    fn = jax.jit(jax.grad(loss, tuple(range(6)), has_aux=True))
    out = []
    for _ in range(runs):
        grads, (img, alpha) = fn(*args)
        out.append([np.asarray(x) for x in (img, alpha, *grads)])
    return out


def _port(arrays, r, s, tplan):
    t = [torch.tensor(a, requires_grad=True) for a in arrays]
    probe = torch.zeros((N, 2), requires_grad=True)
    img, alpha = T.render_plan_train(*t[:4], tplan, background=t[4], trans_eps=1e-4,
                                     abs_probe=probe)
    loss = (img * torch.from_numpy(r)).sum() + (alpha * torch.from_numpy(s)).sum()
    grads = torch.autograd.grad(loss, t + [probe])
    return [x.detach().numpy() for x in (img, alpha, *grads)]


@pytest.mark.parametrize("tile, d", [(8, 5), (8, 300), (12, 5), (12, 300), (48, 5)])
def test_render_plan_train_matches_tpugs_at_other_tiles(tile, d):
    arrays, r, s, jplan, tplan = _train_inputs(d, tile)
    runs = 2 if tile == 8 else 1  # at tile 8 both packages give the same bits twice
    ref, *again = _reference(arrays, r, s, jplan, runs)
    got = _port(arrays, r, s, tplan)
    for other in again:
        for a, b in zip(ref, other):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got, _port(arrays, r, s, tplan)):
            np.testing.assert_array_equal(a, b)
    assert got[0].shape == (H, W, d) and got[1].shape == (H, W)
    _within(got[0], ref[0], 1e-5, "image")
    _within(got[1], ref[1], 1e-5, "alpha")
    for name, a, b in zip(NAMES, got[2:], ref[2:]):
        assert a.shape == b.shape, name
        _within(a, b, 3e-4, name)


# ------------------------------------------------- render_tiled past 4096


def _absgrad_autodiff(inputs, plan, g, s):
    """The absgrad statistic (N, 2) by autograd through the block walk,
    each (pixel, Gaussian) pair reading its own leaf copy of the mean;
    per Gaussian, the absolute values of those copies' gradients summed
    over pixels."""
    m2d, con, opa, colors, bg = (x.detach() for x in inputs)
    n, d, ts = m2d.shape[0], colors.shape[1], plan.tile_size
    order = plan.order
    m = torch.cat([m2d[order], m2d.new_zeros((1, 2))])
    c = torch.cat([con[order], con.new_ones((1, 3))])
    o = torch.cat([opa[order], opa.new_zeros((1,))])
    col = torch.cat([colors[order], colors.new_zeros((1, d))])
    gid_of = torch.cat([plan.padded_gid.long(), torch.full((1,), n)])
    spans = (plan.tile_ends - plan.tile_starts).long()
    j = torch.arange(128)
    in_span = j[None, :] < spans[:, None]
    assert int(spans.max()) <= 128, "one block a tile"
    gid = gid_of[torch.where(in_span, plan.padded_starts.long()[:, None] + j, plan.T_padded)]
    px, py = _tile_pixels(torch.arange(plan.n_tiles), plan.grid[0], ts)
    mx, my = (m[gid, k][..., None].expand(-1, -1, ts * ts).clone().requires_grad_()
              for k in (0, 1))
    alpha = evaluate_alpha(c[gid][:, :, None, :], o[gid][..., None], px[:, None, :] - mx,
                           py[:, None, :] - my)
    alpha = torch.where(in_span[..., None], alpha, torch.zeros_like(alpha))
    cum = torch.cumprod(1.0 - alpha, dim=1)
    texc = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    img = torch.einsum("tbp,tbd->tpd", alpha * texc, col[gid])
    trans = cum[:, -1]
    image = tiles_to_image(img + trans[..., None] * bg, plan.width, plan.height, ts)
    alpha_img = tiles_to_image((1.0 - trans)[..., None], plan.width, plan.height, ts)[..., 0]
    gx, gy = torch.autograd.grad((image * g).sum() + (alpha_img * s).sum(), [mx, my])
    sums = torch.zeros((n + 1, 2))
    sums.index_add_(0, gid.reshape(-1),
                    torch.stack([gx.abs().sum(-1), gy.abs().sum(-1)], -1).reshape(-1, 2))
    out = torch.zeros((n, 2))
    out[order] = sums[:n]
    return out


def test_render_tiled_absgrad_past_4096_channels_matches_autodiff():
    w = h = 32
    d = 4097
    js = random_scene(20, seed=4, extent=0.6, scale_range=(0.05, 0.2))
    jc = orbit_cameras(1, w, h, radius=2.5)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}, device="cpu")
    vm, Km = (torch.from_numpy(np.array(x[0], dtype=np.float32)) for x in (jc.viewmats, jc.Ks))
    proj = project(ts.means, ts.quats, ts.scales, ts.opacities, vm, Km, w, h)
    plan = build_plan(proj, w, h, 16)
    rng = np.random.default_rng(7)
    colors = torch.from_numpy(rng.uniform(0, 1, (20, d)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(h, w, d)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(h, w)).astype(np.float32))
    bg = torch.from_numpy(rng.uniform(0, 1, d).astype(np.float32))
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    inputs = [proj.means2d, proj.conics, opac, colors, bg]
    assert bool(proj.valid.any())
    with pytest.raises(ValueError, match="GEOM_MAX_CHANNELS"):
        T.train_layout(16, T.GEOM_MAX_CHANNELS + 1)  # the card's cap; the twin takes any D

    def grads(fn, probe):
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        extra = {"abs_probe": torch.zeros((20, 2), requires_grad=True)} if probe else {}
        img, alpha = fn(*leaves[:4], plan, TileConfig(16), background=leaves[4], **extra)
        out = torch.autograd.grad((img * g).sum() + (alpha * s).sum(),
                                  leaves + list(extra.values()))
        return img.detach(), alpha.detach(), out

    img, alpha, got = grads(render_tiled, True)
    img_r, alpha_r, ref = grads(render_tiled_autodiff, False)
    ref = list(ref) + [_absgrad_autodiff(inputs, plan, g, s)]
    assert img.shape == (h, w, d)
    _within(img.numpy(), img_r.numpy(), 5e-5, "image")
    _within(alpha.numpy(), alpha_r.numpy(), 5e-5, "alpha")
    for name, a, b in zip(NAMES, got, ref):
        _within(a.numpy(), b.numpy(), 5e-5, name)


# ------------------------------------------------------------ the layouts

WIDTHS = (3, 131, 256, 257, 515, 1027, 4097, T.GEOM_MAX_CHANNELS)


def _covered_once(xs, ys, real, ts):
    """Each of the tile's ts*ts pixels is the pixel of exactly one real
    slot; real slots lie in the tile."""
    xs, ys = xs[real], ys[real]
    assert ((xs >= 0) & (xs < ts) & (ys >= 0) & (ys < ts)).all()
    counts = np.bincount(ys * ts + xs, minlength=ts * ts)
    assert counts.shape == (ts * ts,) and (counts == 1).all()


def _render_slots(ts):
    """B1's slots (CTA, warp, lane) -> pixel: warp 8 k + w of CTA k (rank k
    % C of pixel group k // C) takes the tile's warp rectangle of that
    index, row-major (csrc/render.cu)."""
    c, p, g = K.render_cluster(ts)
    slot = np.arange(c * g * p)
    r, lane = slot // 32, slot % 32
    rects_x = -(-ts // K.RECT_W)
    rects = rects_x * -(-ts // K.RECT_H)
    xs = (r % rects_x) * K.RECT_W + lane % K.RECT_W
    ys = (r // rects_x) * K.RECT_H + lane // K.RECT_W
    real = (r < rects) & (xs < ts) & (ys < ts)
    return (c, p, g), xs, ys, real, rects * K.RECT_W * K.RECT_H


def _rank_slots(ranks, p, ts, blocks):
    """Slots (rank, l) of ranks of p pixels -> pixel: at tiles 16 and 32
    the kernels' blocks of pixel rows (``blocks`` (l, rank) -> (x, y)),
    elsewhere the rank's slots p rank + l, row-major over the tile."""
    rank, l = np.divmod(np.arange(ranks * p), p)
    if ts in (16, 32) and blocks is not None:
        xs, ys = blocks(l, rank)
    else:
        xs, ys = (rank * p + l) % ts, (rank * p + l) // ts
    return xs, ys, ys < ts


def _cluster_blocks(ts):
    def blocks(l, rank):  # local_xy in csrc/train_bwd.cu
        w, lane, per_row = l >> 5, l & 31, ts >> 3
        return 8 * (w % per_row) + (lane & 7), rank * (128 // ts) + 4 * (w // per_row) + (lane >> 3)
    return blocks


def _geom_blocks(ts, p):
    def blocks(l, rank):  # geom_xy in csrc/train_bwd.cu
        bw = p // 4
        pw = min(bw, 8)
        per_row, li = ts // bw, l % (4 * pw)
        return bw * (rank % per_row) + pw * (l // (4 * pw)) + li % pw, 4 * (rank // per_row) + li // pw
    return blocks


def _grouped(layout, xs, ys, real, ts, ghost_unit):
    """The slots of C ranks a group, G groups, P slots a rank: each pixel
    once; fewer ghosts than ``ghost_unit`` slots a group (None: B1, whose
    rectangles' rounding adds more, checked by the caller); every group
    holds a pixel. Returns the group of each pixel (ts*ts,), row-major."""
    c, p, g = layout
    _covered_once(xs, ys, real, ts)
    if ghost_unit is not None:
        assert 0 <= c * g * p - ts * ts < g * ghost_unit, "fewer ghosts than one unit a group"
    group = np.arange(c * g * p) // (c * p)
    assert real.reshape(g, c * p).any(1).all(), "every pixel group holds a pixel"
    of_pixel = np.empty(ts * ts, dtype=np.int64)
    of_pixel[ys[real] * ts + xs[real]] = group[real]
    return of_pixel


LAYOUT_TILES = list(range(1, 65)) + [96, 128]


@pytest.mark.parametrize("ts", LAYOUT_TILES)
def test_every_kernel_layout_covers_the_tile_once(ts):
    (c, p, g), xs, ys, real, rounded = _render_slots(ts)
    assert p == K.RENDER_THREADS and c <= K.MAX_CLUSTER
    assert (g == 1) == (rounded <= K.MAX_CLUSTER * p), "one cluster while the CTAs fit one"
    assert 0 <= c * g * p - rounded < g * p
    of_pixel = _grouped((c, p, g), xs, ys, real, ts, None)
    assert np.array_equal(K.render_groups(ts).numpy(), of_pixel), "the vote's groups are B1's"
    for dtype in K.CONTRIB_DTYPES:
        groups, p = K.adjoint_groups(ts, dtype)
        slot = np.arange(groups * p)
        _covered_once(slot % ts, slot // ts, slot < ts * ts, ts)
        assert 0 <= groups * p - ts * ts < p
    c, p, g, s, ns = T.train_fwd_cluster(ts, 131)
    assert (c, p, g) == T.rank_groups(ts) and (s, ns) == T.fwd_slices(131)
    assert p == T.PIXELS_PER_RANK and c <= K.MAX_CLUSTER and (g == 1) == (ts <= 32)
    of_pixel = _grouped((c, p, g), *_rank_slots(c * g, p, ts, None), ts, p)
    assert np.array_equal(T.train_fwd_groups(ts).numpy(), of_pixel), "the vote's groups are B4's"
    for d in WIDTHS:
        layout = T.train_layout(ts, d)
        c, p, g = layout["cluster"] if "cluster" in layout else layout["colour"][:3]
        assert (c, p, g) == T.rank_groups(ts) and c <= K.MAX_CLUSTER
        _grouped((c, p, g), *_rank_slots(c * g, p, ts, _cluster_blocks(ts)), ts, p)
        c, p, g = T.geom_cluster(ts, d)
        assert c <= T.GEOM_MAX_CLUSTER and p == next(q for widest, q in T.GEOM_WIDTHS
                                                     if d <= widest)
        _grouped((c, p, g), *_rank_slots(c * g, p, ts, _geom_blocks(ts, p) if p >= 8 else None),
                 ts, p)
        if ts in (16, 32) and p >= 8:
            assert c * g * p == ts * ts


@pytest.mark.parametrize("ts", [0, 33])
def test_layouts_refuse_tiles_past_the_cap(ts):
    """Tile 0 is refused by every layout; tile 33, past the old cap of 32,
    is taken by every one (B1 in one cluster of 6 CTAs, B4 and B5 in two
    pixel groups of 5 ranks)."""
    calls = {"B1": lambda: K.render_cluster(ts), "B2": lambda: K.adjoint_groups(ts, torch.float32),
             "B5": lambda: T.train_layout(ts, 3), "B5 geometry": lambda: T.geom_cluster(ts, 3),
             "B4": lambda: T.train_fwd_cluster(ts, 3)}
    if ts == 0:
        for call in calls.values():
            with pytest.raises(ValueError, match="at least 1 pixel"):
                call()
        return
    got = {name: call() for name, call in calls.items()}
    assert got == {"B1": (6, 256, 1), "B2": (69, 16), "B5": {"cluster": (5, 128, 2)},
                   "B5 geometry": (9, 64, 2), "B4": (5, 128, 2, 1, 16)}


# ------------------------------------------------------------ the exit vote


def _planted_tile(ts):
    """One ts x ts tile: 160 opaque Gaussians nearest the camera cover the
    rows to 0.75 ts (centres every 0.05 ts, narrow in y), then 1000 faint
    ones (opacity 0.03) centred in the bottom rows, broad, so that the
    pixels below 0.75 ts keep T above trans_eps for blocks after the rest.
    Returns (B1's pack, B4's packs, plan)."""
    rng = np.random.default_rng(ts)
    n_cover, n_faint = 160, 1000
    cy = np.tile(np.arange(0.0, 0.76, 0.05), 10) * ts
    cx = rng.uniform(0.1, 0.9, n_cover) * ts
    fx = rng.uniform(0.0, 1.0, n_faint) * ts
    fy = rng.uniform(0.88, 0.95, n_faint) * ts
    means = np.concatenate([np.stack([cx, cy], 1), np.stack([fx, fy], 1)]).astype(np.float32)
    conics = np.concatenate([np.tile([1.0 / ts**2, 0.0, 1100.0 / ts**2], (n_cover, 1)),
                             np.tile([2.0 / ts**2, 0.0, 20.0 / ts**2], (n_faint, 1))])
    opac = np.concatenate([np.full(n_cover, 0.99), np.full(n_faint, 0.03)]).astype(np.float32)
    depths = np.concatenate([rng.uniform(1.0, 1.1, n_cover), rng.uniform(2.0, 3.0, n_faint)])
    n = n_cover + n_faint
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    proj = Projected(t(means), t(conics), t(depths), t(np.full(n, 4.0 * ts)), t(opac),
                     torch.ones(n, dtype=torch.bool), t(np.full(n, 64.0 * ts * ts)),
                     t(np.log(255.0 * opac)))
    plan = build_plan(proj, ts, ts, ts)
    colors = t(rng.uniform(0, 1, (n, 3)))
    geom, cols = T.pack_train(proj.means2d, proj.conics, proj.opacities, colors, plan)
    return pack_isect_all(proj, colors, plan), (geom, cols), plan


@pytest.mark.parametrize("ts", [33, 48, 64])
def test_exit_vote_plain_is_the_whole_tile_exit(ts):
    pack, (geom, cols), plan = _planted_tile(ts)
    assert plan.n_tiles == 1 and int(plan.tile_ends[0] - plan.tile_starts[0]) == 1160
    _, done_b1 = K.render_tiles_plain(pack, plan)
    _, _, done_b4 = T.train_tiles_plain(geom, cols, plan)
    assert torch.equal(done_b1, done_b4) and int(done_b1[0]) < 9, "the faint pixels exit"
    voted = 0
    for packed, groups in ((pack, K.render_groups(ts)), (geom, T.train_fwd_groups(ts))):
        own, done = K.exit_vote_plain(packed, plan, groups)
        assert own.shape == (1, int(groups.max()) + 1) and own.dtype == torch.int32
        assert torch.equal(done, done_b1), "the largest group exit is the tile's"
        if own.shape[1] == 1:
            continue
        voted += 1
        planted = int(groups[ts * ts - 1])  # the bottom rows' group
        others = torch.cat([own[:, :planted], own[:, planted + 1:]], 1)
        assert int(own[0, planted]) >= int(others.max()) + 3, "the plant keeps its group walking"
        assert int(own[0, planted]) == int(done[0])
    assert voted == (1 if ts == 33 else 2)  # B1's tile 33 is one cluster
