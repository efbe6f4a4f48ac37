"""The gsplat-shaped raster API and the tiled render on the kernels' twins,
against tpugs (JAX on the CPU, its pure-JAX tiled path) on numpy-seeded
scenes at 64x48, 3 orbit cameras.

* ``rasterize`` in every render mode, with one background, (C, 3)
  backgrounds and ``radius_clip``, and its meta dict: 2e-5 absolute on
  images and alphas (tpugs' tiled-against-naive limit), ED channels 2e-5
  relative to their max; ``means2d``/``depths`` 1e-4 absolute, ``radii``
  equal;
* at 72x44 (partial edge tiles), 2 cameras, RGB+ED with (C, 3)
  backgrounds: the same limits, and the gradients of one camera's render
  against ``jax.grad`` of tpugs', 5e-5 of each max;
* the empty scene renders the background (1e-6); ``pad_to`` changes no
  pixel (1e-6), as tpugs' ``tests/test_rasterizer.py`` holds;
* gradients of ``rasterize_with_plan`` by means, quats, scales, opacities
  and colours against ``jax.grad`` of tpugs' (its custom VJP): 5e-5 of each
  gradient's max (``tests/test_rasterizer.py``'s limit);
* ``render_tiled`` (``RenderTrain`` on the twins) against
  ``render_tiled_autodiff``: image and alpha 2e-5, every gradient
  (means2d, conics, opacities, colours, background) 5e-5 of its max;
  at D = 515 (colour slices plus the geometry launch) the same limits;
  at D = 1027 (DINOv2's 1024 + RGB) with the absgrad probe the same limits,
  the probe's gradient against autograd through the same walk with a leaf
  copy of each mean per pixel (each pixel's gradient its own; the
  absolute values summed over pixels), 5e-5 of its max;
* ``render_tiled`` at D = 4 and 515 against ``jax.grad`` of tpugs'
  ``render_tiled`` on the binning of the same projection: image and alpha
  2e-5, every gradient 5e-5 of its max; the absgrad probe at D = 4 and
  515 (B5's geometry columns over all channels) against ``jax.grad`` of
  tpugs' probe, 5e-5 of its max;
* ``render_tiled_autodiff``'s block size and tiles per chunk change no
  pixel beyond 1e-5 (tpugs' ``test_tiled_block_boundary_invariance``);
* the binning: ``tile_cut_mask``, ``culled_covers`` and
  ``build_tile_binning`` equal to tpugs' on the same projection.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.raster import api as ja
from tpugs.raster import binning as jb
from tpugs.raster.projection import Projected as JProjected
from tpugs.raster.projection import project as j_project
from tpugs.raster.tiled import render_tiled as j_render_tiled
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch import rasterize
from tpugs_torch.convert import SCENE_FIELDS, scene_from_numpy
from tpugs_torch.raster import binning as tb
from tpugs_torch.raster.api import plan_render, rasterize_with_plan
from tpugs_torch.raster.plan import build_plan
from tpugs_torch.raster.projection import project
from tpugs_torch.raster.tiled import (
    TileConfig,
    render_tiled,
    render_tiled_autodiff,
    required_blocks,
)
from tpugs_torch.raster.kernels import _tile_pixels
from tpugs_torch.raster.naive import evaluate_alpha
from tpugs_torch.raster.tiles import tiles_to_image

W, H = 64, 48
_j_binning = jax.jit(jb.build_tile_binning, static_argnums=(1, 2, 3, 4))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def setup():
    js = random_scene(150, seed=0, sh_degree=3, extent=0.8, scale_range=(0.02, 0.12))
    jc = orbit_cameras(3, W, H, radius=2.5)
    ts = scene_from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}, device="cpu")
    return js, jc, ts


def _jargs(js):
    return js.means, js.quats, js.scales, js.opacities


def _targs(ts):
    return ts.means, ts.quats, ts.scales, ts.opacities


def _close(got, ref, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, err_msg=what)


@pytest.mark.parametrize("mode", ["RGB", "D", "ED", "RGB+D", "RGB+ED"])
def test_rasterize_matches_tpugs_in_every_mode(setup, mode):
    js, jc, ts = setup
    bgs = np.array([[0.2, 0.4, 0.6], [1.0, 0.0, 0.5], [0.0, 0.3, 0.9]], np.float32)
    kw = dict(sh_degree=3, render_mode=mode, backgrounds=bgs, radius_clip=1.0)
    imgs_j, alphas_j, meta_j = ja.rasterize(*_jargs(js), js.colors_all, jc.viewmats, jc.Ks,
                                            W, H, **kw)
    imgs, alphas, meta = rasterize(*_targs(ts), ts.colors_all, np.array(jc.viewmats),
                                   np.array(jc.Ks), W, H, **kw)
    depth = mode != "RGB"
    assert imgs.shape == imgs_j.shape == (3, H, W, (3 if "RGB" in mode else 0) + depth)
    assert alphas.shape == (3, H, W, 1)
    imgs_j = np.asarray(imgs_j)
    if "ED" in mode:
        ed, ed_j = imgs[..., -1].numpy(), imgs_j[..., -1]
        _close(ed / np.abs(ed_j).max(), ed_j / np.abs(ed_j).max(), 2e-5, "ED channel")
        imgs, imgs_j = imgs[..., :-1], imgs_j[..., :-1]
    _close(imgs.numpy(), imgs_j, 2e-5, "images")
    _close(alphas.numpy(), alphas_j, 2e-5, "alphas")
    _close(meta["means2d"].numpy(), meta_j["means2d"], 1e-4, "means2d")
    _close(meta["depths"].numpy(), meta_j["depths"], 1e-4, "depths")
    np.testing.assert_array_equal(meta["radii"].numpy(), np.asarray(meta_j["radii"]))
    assert len(meta["plans"]) == 3 and meta["plans"][0].tile_size == 16
    np.testing.assert_array_equal(meta["plans"][1].order.numpy(),
                                  np.asarray(meta_j["plans"][1].order))


def test_rasterize_with_partial_edge_tiles_matches_tpugs(setup):
    js, _, ts = setup
    ew, eh = 72, 44
    jc = orbit_cameras(2, ew, eh, radius=2.5)
    bgs = np.array([[0.2, 0.4, 0.6], [1.0, 0.0, 0.5]], np.float32)
    kw = dict(sh_degree=3, render_mode="RGB+ED", backgrounds=bgs)
    imgs_j, alphas_j, meta_j = ja.rasterize(*_jargs(js), js.colors_all, jc.viewmats, jc.Ks,
                                            ew, eh, **kw)
    leaves = [x.detach().clone().requires_grad_() for x in (*_targs(ts), ts.colors_all)]
    imgs, alphas, meta = rasterize(*leaves, np.array(jc.viewmats), np.array(jc.Ks), ew, eh,
                                   **kw)
    assert imgs.shape == (2, eh, ew, 4)
    imgs_j = np.asarray(imgs_j)
    ed, ed_j = imgs[..., -1].detach().numpy(), imgs_j[..., -1]
    _close(ed / np.abs(ed_j).max(), ed_j / np.abs(ed_j).max(), 2e-5, "ED channel")
    _close(imgs[..., :3].detach().numpy(), imgs_j[..., :3], 2e-5, "images")
    _close(alphas.detach().numpy(), alphas_j, 2e-5, "alphas")
    _close(meta["means2d"].numpy(), meta_j["means2d"], 1e-4, "means2d")
    np.testing.assert_array_equal(meta["radii"].numpy(), np.asarray(meta_j["radii"]))
    target = np.random.default_rng(6).normal(size=(eh, ew, 4)).astype(np.float32)

    plan_j = ja.plan_render(*_jargs(js), jc.viewmats[1], jc.Ks[1], ew, eh)

    def loss_j(*a):
        img, _ = ja.rasterize_with_plan(*a, jc.viewmats[1], jc.Ks[1], plan_j, 3, "RGB+ED",
                                        bgs[1])
        return jnp.sum(img[..., :3] * target[..., :3])

    g_ref = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3, 4)))(*_jargs(js), js.colors_all)
    grads = torch.autograd.grad((imgs[1, ..., :3] * torch.from_numpy(target[..., :3])).sum(),
                                leaves)
    for name, g, r in zip(("means", "quats", "scales", "opacities", "colors"), grads, g_ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        assert scale > 0, name
        _close(g.numpy() / scale, r / scale, 5e-5, name)


def test_rasterize_one_background_and_direct_colours(setup):
    js, jc, ts = setup
    cols = jnp.abs(js.sh0[:, 0, :])
    bg = np.array([1.0, 0.0, 0.5], np.float32)
    imgs_j, _, _ = ja.rasterize(*_jargs(js), js.sh0, jc.viewmats[1], jc.Ks[1], W, H,
                                backgrounds=bg)
    imgs, _, _ = rasterize(*_targs(ts), ts.sh0, _t(jc.viewmats[1]), _t(jc.Ks[1]), W, H,
                           backgrounds=bg)
    _close(imgs.numpy(), imgs_j, 2e-5, "(N, 1, 3) colours without SH")
    imgs_j, _, _ = ja.rasterize(*_jargs(js), cols, jc.viewmats, jc.Ks, W, H, backgrounds=bg)
    imgs, _, _ = rasterize(*_targs(ts), _t(cols), _t(jc.viewmats), _t(jc.Ks), W, H,
                           backgrounds=bg)
    _close(imgs.numpy(), imgs_j, 2e-5, "(N, 3) colours")


def test_empty_scene_renders_the_background(setup):
    _, jc, ts = setup
    far = ts.replace(means=ts.means + torch.tensor([0.0, 0.0, 1e4]))
    plan = plan_render(*_targs(far), _t(jc.viewmats[0]), _t(jc.Ks[0]), W, H)
    assert plan.plan.n_isects == 0
    img, alpha = rasterize_with_plan(*_targs(far), far.sh0[:, 0], _t(jc.viewmats[0]),
                                     _t(jc.Ks[0]), plan, background=torch.tensor([0.2, 0.4, 0.6]))
    _close(alpha.numpy(), np.zeros((H, W)), 1e-7, "alpha")
    _close(img.numpy(), np.broadcast_to([0.2, 0.4, 0.6], (H, W, 3)), 1e-6, "background")


def test_padding_changes_no_pixel(setup):
    _, jc, ts = setup
    vm, K = _t(jc.viewmats[0]), _t(jc.Ks[0])
    img, _ = rasterize_with_plan(*_targs(ts), ts.colors_all, vm, K,
                                 plan_render(*_targs(ts), vm, K, W, H), sh_degree=3)
    padded = ts.pad_to(256)
    assert padded.num_gaussians == 256 and ts.pad_to(150) is ts
    img_p, _ = rasterize_with_plan(*_targs(padded), padded.colors_all, vm, K,
                                   plan_render(*_targs(padded), vm, K, W, H), sh_degree=3)
    _close(img_p.numpy(), img.numpy(), 1e-6, "padded scene")
    with pytest.raises(ValueError):
        ts.pad_to(10)


def test_rasterize_with_plan_gradients_match_jax(setup):
    js, jc, ts = setup
    vm, K = jc.viewmats[0], jc.Ks[0]
    cols = jnp.abs(js.sh0[:, 0, :])
    target = np.random.default_rng(2).uniform(0, 1, (H, W, 3)).astype(np.float32)
    plan_j = ja.plan_render(*_jargs(js), vm, K, W, H)

    def loss_j(*a):
        img, _ = ja.rasterize_with_plan(*a, vm, K, plan_j, background=jnp.array([0.3, 0.1, 0.2]))
        return jnp.sum((img - target) ** 2)

    g_ref = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3, 4)))(*_jargs(js), cols)
    leaves = [_t(a).requires_grad_() for a in (*_jargs(js), cols)]
    plan = plan_render(*leaves[:4], _t(vm), _t(K), W, H)
    img, _ = rasterize_with_plan(*leaves, _t(vm), _t(K), plan,
                                 background=torch.tensor([0.3, 0.1, 0.2]))
    grads = torch.autograd.grad(((img - torch.from_numpy(target)) ** 2).sum(), leaves)
    for name, g, r in zip(("means", "quats", "scales", "opacities", "colors"), grads, g_ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        assert scale > 0, name
        _close(g.numpy() / scale, r / scale, 5e-5, name)


def _view_inputs(ts, jc, cam, d, seed):
    vm, K = _t(jc.viewmats[cam]), _t(jc.Ks[cam])
    proj = project(*_targs(ts), vm, K, W, H)
    plan = build_plan(proj, W, H, 16)
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    rng = np.random.default_rng(seed)
    colors = torch.from_numpy(rng.uniform(0, 1, (ts.num_gaussians, d)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(H, W, d)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32))
    bg = torch.from_numpy(rng.uniform(0, 1, d).astype(np.float32))
    return proj, plan, [proj.means2d, proj.conics, opac, colors, bg], g, s


def _grads(fn, inputs, plan, g, s, probe=False):
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    extra = {}
    if probe:
        extra["abs_probe"] = torch.zeros((leaves[0].shape[0], 2), requires_grad=True)
    img, alpha = fn(*leaves[:4], plan, background=leaves[4], **extra)
    loss = (img * g).sum() + (alpha * s).sum()
    grads = torch.autograd.grad(loss, leaves + list(extra.values()))
    return img.detach(), alpha.detach(), grads


NAMES = ("means2d", "conics", "opacities", "colors", "background")


@pytest.mark.parametrize("d", [3, 4, 515])
def test_render_tiled_matches_autodiff(setup, d):
    _, jc, ts = setup
    _, plan, inputs, g, s = _view_inputs(ts, jc, 1, d, d)
    img, alpha, grads = _grads(render_tiled, inputs, plan, g, s)
    img_r, alpha_r, grads_r = _grads(render_tiled_autodiff, inputs, plan, g, s)
    assert img.shape == (H, W, d)
    _close(img, img_r, 2e-5, "image")
    _close(alpha, alpha_r, 2e-5, "alpha")
    for name, a, b in zip(NAMES, grads, grads_r):
        scale = float(b.abs().max())
        assert scale > 0, name
        _close(a / scale, b / scale, 5e-5, name)


@pytest.mark.parametrize("d", [4, 515])
def test_render_tiled_matches_tpugs(setup, d):
    _, jc, ts = setup
    proj, plan, inputs, g, s = _view_inputs(ts, jc, 1, d, d)
    img, alpha, grads = _grads(render_tiled, inputs, plan, g, s)
    binning = _j_binning(JProjected(*(jnp.asarray(x.numpy()) for x in proj)), 16, W, H, 64)
    assert int(binning.max_cover_req) <= 64
    order = binning.order
    nblk = max(1, -(-int(binning.max_span) // 128))

    def loss_j(m2d, con, opa, cols, bg):
        img, alpha = j_render_tiled(m2d[order], con[order], opa[order], cols[order],
                                    binning.sorted_gid, binning.tile_starts, W, H, nblk,
                                    background=bg)
        return jnp.sum(img * g.numpy()) + jnp.sum(alpha * s.numpy()), (img, alpha)

    jin = [jnp.asarray(x.numpy()) for x in inputs]
    grads_j, (img_j, alpha_j) = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3, 4),
                                                 has_aux=True))(*jin)
    _close(img, img_j, 2e-5, "image")
    _close(alpha, alpha_j, 2e-5, "alpha")
    for name, a, b in zip(NAMES, grads, grads_j):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0, name
        _close(a / scale, b / scale, 5e-5, name)


@pytest.mark.parametrize("d", [4, 515])
def test_render_tiled_absgrad_matches_tpugs(setup, d):
    js, jc, ts = setup
    proj, plan, inputs, g, s = _view_inputs(ts, jc, 2, d, 7)
    img, _, grads = _grads(render_tiled, inputs, plan, g, s, probe=True)
    jp = j_project(*_jargs(js), jc.viewmats[2], jc.Ks[2], W, H)
    binning = _j_binning(jp, 16, W, H, 64)
    order = binning.order
    m2d, con, opa, cols, bg = (jnp.asarray(x.numpy()) for x in inputs)
    nblk = max(1, -(-int(binning.max_span) // 128))

    def loss_j(probe):
        img, alpha = j_render_tiled(m2d[order], con[order], opa[order], cols[order],
                                    binning.sorted_gid, binning.tile_starts, W, H, nblk,
                                    background=bg, abs_probe=probe[order])
        return jnp.sum(img * g.numpy()) + jnp.sum(alpha * s.numpy())

    ref = np.asarray(jax.jit(jax.grad(loss_j))(jnp.zeros((ts.num_gaussians, 2))))
    scale = float(np.abs(ref).max())
    assert scale > 0
    _close(grads[5].numpy() / scale, ref / scale, 5e-5, "absgrad")


def _absgrad_autodiff(inputs, plan, g, s):
    """The absgrad statistic (N, 2) by autograd through
    ``render_tiled_autodiff``'s walk (blocks of 128, every tile at once),
    where each (pixel, Gaussian) pair reads its own leaf copy of the
    Gaussian's mean: the gradient of that copy is the pixel's; per
    Gaussian, its absolute values summed over the pixels."""
    m2d, con, opa, colors, bg = (x.detach() for x in inputs)
    n, d, ts = m2d.shape[0], colors.shape[1], plan.tile_size
    order = plan.order
    m = torch.cat([m2d[order], m2d.new_zeros((1, 2))])
    c = torch.cat([con[order], con.new_ones((1, 3))])
    o = torch.cat([opa[order], opa.new_zeros((1,))])
    col = torch.cat([colors[order], colors.new_zeros((1, d))])
    gid_of = torch.cat([plan.padded_gid.long(), torch.full((1,), n)])
    spans = (plan.tile_ends - plan.tile_starts).long()
    px, py = _tile_pixels(torch.arange(plan.n_tiles), plan.grid[0], ts)
    img = torch.zeros((plan.n_tiles, ts * ts, d))
    trans = torch.ones((plan.n_tiles, ts * ts))
    copies, gids = [], []
    for b in range(required_blocks(plan, 128)):
        j = b * 128 + torch.arange(128)
        in_span = j[None, :] < spans[:, None]
        gid = gid_of[torch.where(in_span, plan.padded_starts.long()[:, None] + j, plan.T_padded)]
        mx, my = (m[gid, k][..., None].expand(-1, -1, ts * ts).clone().requires_grad_()
                  for k in (0, 1))
        alpha = evaluate_alpha(c[gid][:, :, None, :], o[gid][..., None], px[:, None, :] - mx,
                               py[:, None, :] - my)
        alpha = torch.where(in_span[..., None], alpha, torch.zeros_like(alpha))
        cum = torch.cumprod(1.0 - alpha, dim=1)
        texc = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        img = img + torch.einsum("tbp,tbd->tpd", alpha * texc * trans[:, None, :], col[gid])
        trans = trans * cum[:, -1]
        copies += [mx, my]
        gids.append(gid)
    w, h = plan.width, plan.height
    image = tiles_to_image(img + trans[..., None] * bg, w, h, ts)
    alpha = tiles_to_image((1.0 - trans)[..., None], w, h, ts)[..., 0]
    grads = torch.autograd.grad((image * g).sum() + (alpha * s).sum(), copies)
    sums = torch.zeros((n + 1, 2))
    for gid, gx, gy in zip(gids, grads[0::2], grads[1::2]):
        sums.index_add_(0, gid.reshape(-1),
                        torch.stack([gx.abs().sum(-1), gy.abs().sum(-1)], -1).reshape(-1, 2))
    out = torch.zeros((n, 2))
    out[order] = sums[:n]
    return out


def test_render_tiled_absgrad_above_700_channels_matches_autodiff(setup):
    """D = 1027, above the geometry kernel's 64-pixel ranks (700 channels):
    one ``train_rows`` over all channels gives every gradient and the
    absgrad columns."""
    _, jc, ts = setup
    _, plan, inputs, g, s = _view_inputs(ts, jc, 2, 1027, 11)
    img, alpha, grads = _grads(render_tiled, inputs, plan, g, s, probe=True)
    img_r, alpha_r, grads_r = _grads(render_tiled_autodiff, inputs, plan, g, s)
    _close(img, img_r, 2e-5, "image")
    _close(alpha, alpha_r, 2e-5, "alpha")
    refs = list(grads_r) + [_absgrad_autodiff(inputs, plan, g, s)]
    for name, a, b in zip(NAMES + ("absgrad",), grads, refs):
        scale = float(b.abs().max())
        assert scale > 0, name
        _close(a / scale, b / scale, 5e-5, name)


def test_autodiff_walk_is_block_invariant(setup):
    _, jc, ts = setup
    _, plan, inputs, _, _ = _view_inputs(ts, jc, 0, 3, 1)
    imgs = [render_tiled_autodiff(*inputs[:4], plan, TileConfig(16, bs, tc))[0]
            for bs, tc in ((16, 3), (64, 32), (128, 7))]
    _close(imgs[0], imgs[1], 1e-5, "block 16 / 64")
    _close(imgs[1], imgs[2], 1e-5, "block 64 / 128")
    assert required_blocks(plan, 16) >= required_blocks(plan, 128) >= 1


def test_tile_config_must_match_the_kernels(setup):
    """Any tile renders (8 and 24 as 16, within 2e-5); a TileConfig of
    another tile than its plan's raises."""
    _, jc, ts = setup
    proj, plan, inputs, _, _ = _view_inputs(ts, jc, 0, 3, 1)
    with pytest.raises(ValueError):
        render_tiled(*inputs[:4], plan, TileConfig(tile_size=8))
    with pytest.raises(ValueError):
        render_tiled(*inputs[:4], plan, TileConfig(tile_size=32))
    ref = render_tiled(*inputs[:4], plan)[0]
    for tile in (8, 24):
        img, _ = render_tiled(*inputs[:4], build_plan(proj, W, H, tile), TileConfig(tile))
        _close(img, ref, 2e-5, f"tile {tile}")
    rp = plan_render(*_targs(ts), _t(jc.viewmats[0]), _t(jc.Ks[0]), W, H,
                     tile_config=TileConfig(tile_size=24))
    assert rp.plan.tile_size == rp.tile_config.tile_size == 24
    img, _ = render_tiled(*inputs[:4], plan, TileConfig(16, 64, 3))
    _close(img, ref, 0.0, "layout knobs")


@pytest.mark.parametrize("cam", [0, 2])
def test_binning_matches_tpugs(setup, cam):
    js, jc, ts = setup
    proj = project(*_targs(ts), _t(jc.viewmats[cam]), _t(jc.Ks[cam]), W, H)
    jp = JProjected(*(jnp.asarray(x.numpy()) for x in proj))  # the same projection
    ref = _j_binning(jp, 16, W, H, 32)
    got = tb.build_tile_binning(proj, 16, W, H, 32)
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    for a, b in zip(tb.culled_covers(proj, 16, W, H, 32),
                    jax.jit(jb.culled_covers, static_argnums=(1, 2, 3, 4))(jp, 16, W, H, 32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tx = torch.randint(0, 4, (ts.num_gaussians, 6), generator=torch.Generator().manual_seed(cam))
    ty = torch.randint(0, 3, tx.shape, generator=torch.Generator().manual_seed(cam + 9))
    np.testing.assert_array_equal(
        tb.tile_cut_mask(proj.means2d, proj.conics, proj.sig_cut, tx, ty, 16).numpy(),
        np.asarray(jax.jit(jb.tile_cut_mask, static_argnums=5)(
            jp.means2d, jp.conics, jp.sig_cut, tx.numpy(), ty.numpy(), 16)))
    # the plan keeps the binning's intersections, tile by tile
    plan = build_plan(proj, W, H, 16)
    assert plan.n_isects == int(got.n_isects)
    np.testing.assert_array_equal((plan.tile_ends - plan.tile_starts).numpy(),
                                  np.diff(got.tile_starts.numpy()))
    assert [tb.bucket(v) for v in (0, 1, 3, 64, 65)] == [jb.bucket(v) for v in (0, 1, 3, 64, 65)]


def test_raster_plan_fields(setup):
    _, jc, ts = setup
    plan = plan_render(*_targs(ts), _t(jc.viewmats[0]), _t(jc.Ks[0]), W, H,
                       tile_config=TileConfig(16, 64, 8))
    assert (plan.width, plan.height, plan.tile_size) == (W, H, 16)
    assert plan.tile_config.block_size == 64
    assert plan.order.shape == (ts.num_gaussians,)
    assert dataclasses.is_dataclass(plan)
