"""B1's per-warp cull on the CPU: ``rect_live``, the twin of the kernel's
``rect_dead`` (``tpugs_torch/csrc/render.cu``), and the twin render with
the culled pairs' alpha forced to 0.

* Property (hypothesis): over conics that are thin, rotated, near-singular,
  not positive definite or far off, means placed so that sigma at the
  rectangle's nearest pixel sits near the cutoff or inside the rectangle
  between its pixel centres, and opacities at the 1/255 edge, ``rect_live`` never marks dead a rectangle in which
  ``_block_terms`` keeps a pixel (alpha >= 1/255). The same over a seeded
  batch of 60,000 such Gaussians, and over non-finite values, which are
  never culled.
* The culled twin render is bit-equal (image and blocks_done) to
  ``render_tiles_plain`` on a seeded scene with early exits, empty tiles
  and partial tiles, at tiles 16 and 32, while culling most pairs.
* The rectangles tile each tile: every pixel lies in its rectangle.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpugs_torch.raster import kernels as K
from tpugs_torch.raster.plan import BLOCK

RX0, RY0 = 40.5, 20.5  # first pixel centre of the tested rectangle


def _rows(mx, my, a, b, c, op):
    """(1, n, 16) pack rows of n Gaussians, n <= BLOCK per call site."""
    cols = [torch.as_tensor(v, dtype=torch.float32).reshape(-1) for v in (mx, my, a, b, c, op)]
    n = cols[0].shape[0]
    geo = torch.zeros((1, n, 16), dtype=torch.float32)
    for k, v in enumerate(cols):
        geo[0, :, k] = v
    return geo


def _kept_anywhere(geo):
    """(n,) True where some pixel centre of the rectangle keeps the pair."""
    lp = torch.arange(K.RECT_W * K.RECT_H)
    px = (RX0 + (lp % K.RECT_W).float())[None]
    py = (RY0 + (lp // K.RECT_W).float())[None]
    valid = torch.ones(geo.shape[:2], dtype=torch.bool)
    return K._block_terms(geo, px, py, valid)["keep"][0].any(0)


def _live(geo):
    valid = torch.ones(geo.shape[:2], dtype=torch.bool)
    x0 = torch.tensor([[RX0]], dtype=torch.float32)
    y0 = torch.tensor([[RY0]], dtype=torch.float32)
    return K.rect_live(geo, x0, y0, valid)[0, 0]


def _conic(lam1, lam2, theta):
    ct, sn = math.cos(theta), math.sin(theta)
    return (lam1 * ct * ct + lam2 * sn * sn, (lam1 - lam2) * sn * ct,
            lam1 * sn * sn + lam2 * ct * ct)


def _near_cutoff_mean(a, b, c, op, k, phi):
    """A mean from which the rectangle's nearest corner region sees sigma
    about k * ln(255 op), in the direction phi from the rectangle."""
    cut = math.log(max(255.0 * op, 1.0)) + 1e-3
    ux, uy = math.cos(phi), math.sin(phi)
    q = 0.5 * (a * ux * ux + c * uy * uy) + b * ux * uy
    d = math.sqrt(max(k * cut, 0.0) / q) if q > 1e-30 else 1e3
    cx, cy = RX0 + 3.5, RY0 + 1.5  # rectangle centre
    hx, hy = 3.5 * math.copysign(1, ux), 1.5 * math.copysign(1, uy)
    return cx + hx + d * ux, cy + hy + d * uy


OPACITIES = st.one_of(
    st.floats(1.0 / 255.0 * (1 - 1e-5), 1.0 / 255.0 * (1 + 1e-5)),
    st.floats(1e-4, 1.0),
    st.sampled_from([1.0 / 255.0, np.nextafter(np.float32(1 / 255), 1).item(), 0.999, 1.0]),
)


@settings(max_examples=400, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    log_l1=st.floats(-12.0, 6.0),
    log_ratio=st.floats(-8.0, 0.0),
    theta=st.floats(0.0, math.pi),
    second=st.sampled_from(["pd", "singular", "negative", "raw"]),
    raw=st.tuples(st.floats(-10, 10), st.floats(-10, 10), st.floats(-10, 10)),
    op=OPACITIES,
    k=st.floats(0.9, 1.1),
    phi=st.floats(0.0, 2 * math.pi),
    place=st.sampled_from(["near cutoff", "far", "inside"]),
    uv=st.tuples(st.floats(0.0, 1.0), st.floats(0.0, 1.0)),
)
def test_rect_live_never_culls_a_kept_pixel(log_l1, log_ratio, theta, second, raw, op, k, phi,
                                            place, uv):
    lam1 = 10.0 ** log_l1
    lam2 = {"pd": lam1 * 10.0 ** log_ratio, "singular": 0.0,
            "negative": -lam1 * 10.0 ** log_ratio, "raw": None}[second]
    if lam2 is None:
        a, b, c = raw
    else:
        a, b, c = _conic(lam1, lam2, theta)
    mx, my = _near_cutoff_mean(a, b, c, op, k, phi)
    if place == "far":
        mx, my = mx + 1e4 * math.cos(phi), my + 1e4 * math.sin(phi)
    elif place == "inside":  # between the pixel centres of the rectangle
        mx, my = RX0 + (K.RECT_W - 1) * uv[0], RY0 + (K.RECT_H - 1) * uv[1]
    geo = _rows([mx], [my], [a], [b], [c], [op])
    live, kept = _live(geo), _kept_anywhere(geo)
    assert not bool((kept & ~live).any()), (mx, my, a, b, c, op)


def test_rect_live_never_culls_a_kept_pixel_in_bulk():
    """60,000 seeded Gaussians around the cutoff: none kept is culled, and
    the cull is not vacuous."""
    rng = np.random.default_rng(7)
    n = 60_000
    lam1 = 10.0 ** rng.uniform(-6, 2, n)
    lam2 = lam1 * 10.0 ** rng.uniform(-7, 0, n)
    lam2[rng.random(n) < 0.05] *= -1.0
    theta = rng.uniform(0, np.pi, n)
    ct, sn = np.cos(theta), np.sin(theta)
    a = lam1 * ct**2 + lam2 * sn**2
    b = (lam1 - lam2) * sn * ct
    c = lam1 * sn**2 + lam2 * ct**2
    op = np.where(rng.random(n) < 0.3, 1 / 255 * (1 + rng.uniform(-1e-4, 1e-4, n)),
                  rng.uniform(1e-3, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    k = rng.uniform(0.95, 1.05, n)
    means = np.array([_near_cutoff_mean(*args) for args in zip(a, b, c, op, k, phi)])
    live_all, kept_all = [], []
    for s in range(0, n, 4096):
        sl = slice(s, s + 4096)
        geo = _rows(means[sl, 0], means[sl, 1], a[sl], b[sl], c[sl], op[sl])
        live_all.append(_live(geo))
        kept_all.append(_kept_anywhere(geo))
    live, kept = torch.cat(live_all), torch.cat(kept_all)
    assert not bool((kept & ~live).any())
    assert 0.05 < float((~live).float().mean()) < 0.95  # both sides of the cutoff


@pytest.mark.parametrize("bad", ["nan_mean", "inf_mean", "nan_conic", "inf_conic", "nan_op",
                                 "inf_op", "zero_a", "negative_c"])
def test_rect_live_never_culls_non_finite_or_non_definite(bad):
    vals = dict(mx=RX0 + 500.0, my=RY0, a=1.0, b=0.0, c=1.0, op=0.9)  # far: dead if finite
    assert not bool(_live(_rows(*[[v] for v in vals.values()])))
    key, v = {"nan_mean": ("mx", math.nan), "inf_mean": ("my", math.inf),
              "nan_conic": ("b", math.nan), "inf_conic": ("a", math.inf),
              "nan_op": ("op", math.nan), "inf_op": ("op", math.inf),
              "zero_a": ("a", 0.0), "negative_c": ("c", -1.0)}[bad]
    vals[key] = v
    assert bool(_live(_rows(*[[v] for v in vals.values()])))


def test_padding_slots_are_never_live():
    geo = _rows([RX0], [RY0], [1.0], [0.0], [1.0], [0.9])
    x0 = torch.tensor([[RX0]], dtype=torch.float32)
    y0 = torch.tensor([[RY0]], dtype=torch.float32)
    assert bool(K.rect_live(geo, x0, y0, torch.ones((1, 1), dtype=torch.bool))[0, 0, 0])
    assert not bool(K.rect_live(geo, x0, y0, torch.zeros((1, 1), dtype=torch.bool))[0, 0, 0])


@pytest.mark.parametrize("ts", [16, 32])
def test_tile_rects_tile_the_tile(ts):
    tiles = torch.tensor([0, 5, 7])
    ntx = 3
    x0, y0, rect_of = K.tile_rects(tiles, ntx, ts)
    assert x0.shape == (3, ts * ts // 32) and rect_of.shape == (ts * ts,)
    px, py = K._tile_pixels(tiles, ntx, ts)
    dx = px - x0[:, rect_of]
    dy = py - y0[:, rect_of]
    assert bool(((dx >= 0) & (dx <= K.RECT_W - 1) & (dy >= 0) & (dy <= K.RECT_H - 1)).all())
    assert torch.equal(torch.bincount(rect_of), torch.full((ts * ts // 32,), 32))


def _scene_plan(ts):
    from tpugs_torch.raster.colors import prepare_colors
    from tpugs_torch.raster.pack import pack_isect_all
    from tpugs_torch.raster.plan import build_plan
    from tpugs_torch.raster.projection import project
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

    w, h = 136, 104  # partial tiles at 16 and 32
    scene = random_scene(3000, seed=4, extent=0.7, scale_range=(0.03, 0.15), device="cpu")
    cams = orbit_cameras(1, w, h, radius=2.6, device="cpu")
    vm, km = cams.viewmats[0], cams.Ks[0]
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, vm, km, w, h)
    plan = build_plan(proj, w, h, ts)
    pack = pack_isect_all(proj, prepare_colors(scene.means, scene.colors_all, vm, 3), plan)
    return pack, plan


@pytest.mark.parametrize("ts", [16, 32])
def test_culled_twin_render_is_bit_equal(ts):
    pack, plan = _scene_plan(ts)
    img, done = K.render_tiles_plain(pack, plan)
    img_c, done_c = K.render_tiles_plain(pack, plan, cull=True)
    assert torch.equal(img_c, img) and torch.equal(done_c, done)
    nb = (plan.tile_ends - plan.tile_starts + BLOCK - 1) // BLOCK
    assert bool((done < nb).any()), "a tile exits early"
    assert bool((nb == 0).any()), "an empty tile"
    assert plan.width % ts and plan.height % ts, "partial tiles"
    counts = torch.zeros(3, dtype=torch.int64)

    def visit(st):
        counts[0] += st.terms["live"].numel()
        counts[1] += st.terms["live"].sum()
        counts[2] += (st.terms["alpha"] != 0).sum()

    K._walk_blocks(pack, plan, K._all_tiles(plan, pack.device), K.TRANS_EPS, visit, cull=True)
    walked, live, nonzero = counts.tolist()
    assert nonzero <= live < walked // 2, (walked, live, nonzero)


def test_cpu_render_counts_no_launch():
    pack, plan = _scene_plan(16)
    K.LAUNCHES.reset()
    got = K.render_tiles(pack, plan)
    got_u = K.render_tiles_unculled(pack, plan)
    ref = K.render_tiles_plain(pack, plan)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert all(torch.equal(x, y) for x, y in zip(got_u, ref))
    assert (K.LAUNCHES.render, K.LAUNCHES.render_unculled) == (0, 0)
