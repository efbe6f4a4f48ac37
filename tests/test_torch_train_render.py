"""The train render's plain twins (B4 forward, B5 backward, B3 reduce)
through the port's ``render_plan_train`` against tpugs' ``render_plan_train``
(Pallas in interpret mode), on the same numpy-seeded inputs: tpugs'
projection of one dense scene (tiles of up to 4 blocks, early exits at
``trans_eps`` 1e-4), random colours, a random background, and one plan
built by each package from those projected arrays.

Tolerances: the forward to 1e-5 of max|ref| (per-block products in another
order); every gradient (means2d, conics, opacities, colours, background,
absgrad) to 3e-4 of its max + 1e-8 (the port's sequential prefix of w*u
against the reference's doubling scan: ``v = grem - prefix`` cancels late
in a span, as ``tests/test_train_pallas.py`` allows); bf16 gradient rows
to 1e-2 of max of the f32 result (one bf16 unit per row, summed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugs.raster.pallas_tiled import build_pallas_plan
from tpugs.raster.pallas_train import render_plan_train as j_render_plan_train
from tpugs.raster.projection import project as j_project
from tpugs.utils.synthetic import orbit_cameras, random_scene
from tpugs_torch.raster import kernels as K
from tpugs_torch.raster.plan import build_plan
from tpugs_torch.raster.projection import Projected
from tpugs_torch.raster.train import (
    GEOM_GRADS,
    GRAD_ROWS_TOL,
    grad_row_width,
    grad_rows_error,
    pack_train,
    render_plan_train,
    train_forward,
    train_rows,
    train_rows_plain,
)

W, H, N = 64, 48, 600
NAMES = ("means2d", "conics", "opacities", "colors", "background", "absgrad")


def _inputs(D, with_bg, tile, seed=0):
    js = random_scene(N, seed=seed, extent=1.0, scale_range=(0.08, 0.25))
    jc = orbit_cameras(2, W, H, radius=2.5)
    vm, Km = jc.viewmats[0], jc.Ks[0]
    jproj = j_project(js.means, js.quats, js.scales, js.opacities, vm, Km, W, H)
    opac = np.asarray(jnp.where(jproj.valid, jproj.opacities, 0.0))
    rng = np.random.default_rng(seed + 100)
    colors = rng.uniform(0, 1, (N, D)).astype(np.float32)
    bg = rng.uniform(0, 1, (D,)).astype(np.float32) if with_bg else None
    r = rng.normal(0, 1, (H, W, D)).astype(np.float32)
    s = rng.normal(0, 1, (H, W)).astype(np.float32)
    jplan = build_pallas_plan(js.means, js.quats, js.scales, js.opacities, vm, Km, W, H,
                              tile_size=tile)
    tproj = Projected(*(torch.from_numpy(np.array(f)) for f in jproj))
    tplan = build_plan(tproj, W, H, tile)
    arrays = [np.asarray(jproj.means2d), np.asarray(jproj.conics), opac, colors, bg]
    return arrays, r, s, jplan, tplan


def _reference(arrays, r, s, jplan, trans_eps, contrib_dtype=jnp.float32):
    with_bg = arrays[4] is not None
    args = [jnp.asarray(a) for a in arrays if a is not None]
    probe = jnp.zeros((N, 2), jnp.float32)

    def loss(m2d, con, op, cols, *rest):
        bg = rest[0] if with_bg else None
        img, alpha = j_render_plan_train(m2d, con, op, cols, jplan, background=bg,
                                         interpret=True, trans_eps=trans_eps,
                                         abs_probe=rest[-1], contrib_dtype=contrib_dtype)
        return jnp.sum(img * r) + jnp.sum(alpha * s), (img, alpha)

    argnums = tuple(range(len(args) + 1))
    grads, (img, alpha) = jax.jit(jax.grad(loss, argnums, has_aux=True))(*args, probe)
    grads = [np.asarray(g) for g in grads]
    if not with_bg:
        grads.insert(4, None)
    return np.asarray(img), np.asarray(alpha), grads


def _port(arrays, r, s, tplan, trans_eps, contrib_dtype=torch.float32):
    t = [None if a is None else torch.tensor(a, requires_grad=True) for a in arrays]
    probe = torch.zeros((N, 2), requires_grad=True)
    img, alpha = render_plan_train(*t[:4], tplan, background=t[4], trans_eps=trans_eps,
                                   abs_probe=probe, contrib_dtype=contrib_dtype)
    loss = (img * torch.from_numpy(r)).sum() + (alpha * torch.from_numpy(s)).sum()
    inputs = [x for x in t if x is not None] + [probe]
    grads = [g.numpy() for g in torch.autograd.grad(loss, inputs)]
    if t[4] is None:
        grads.insert(4, None)
    return img.detach().numpy(), alpha.detach().numpy(), grads


def _within(got, ref, frac, what):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= frac * scale + 1e-8, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


CASES = [  # (D, background, trans_eps, tile)
    (3, False, 0.0, 16),
    (3, True, 1e-4, 32),
    (20, True, 0.0, 32),
    (20, False, 1e-4, 16),
    (300, True, 1e-4, 16),  # above B5's 256-channel cluster kernel: colour slices on the card
]


@pytest.mark.parametrize("D,with_bg,trans_eps,tile", CASES)
def test_render_plan_train_matches_tpugs(D, with_bg, trans_eps, tile):
    arrays, r, s, jplan, tplan = _inputs(D, with_bg, tile)
    img_j, alpha_j, g_j = _reference(arrays, r, s, jplan, trans_eps)
    img, alpha, g = _port(arrays, r, s, tplan, trans_eps)
    assert img.shape == (H, W, D) and alpha.shape == (H, W)
    _within(img, img_j, 1e-5, "image")
    _within(alpha, alpha_j, 1e-5, "alpha")
    for name, got, ref in zip(NAMES, g, g_j):
        if ref is None:
            assert got is None
            continue
        assert got.shape == ref.shape, name
        assert float(np.abs(ref).max()) > 0, name
        _within(got, ref, 3e-4, name)


def test_bf16_rows_within_budget_of_f32():
    arrays, r, s, jplan, tplan = _inputs(8, True, 16, seed=1)
    _, _, g_j = _reference(arrays, r, s, jplan, 0.0)
    _, _, g16 = _port(arrays, r, s, tplan, 0.0, contrib_dtype=torch.bfloat16)
    for name, got, ref in zip(NAMES, g16, g_j):
        _within(got, ref, 1e-2, f"bf16 {name}")


def test_exit_blocks_are_replayed_and_skipped_rows_are_zero():
    """B5 walks exactly the blocks B4 reports and zeroes the rest: a tile
    told to walk no block writes only zero rows."""
    arrays, r, s, _, tplan = _inputs(3, False, 16)
    m2d, con, op, cols = (torch.from_numpy(a) for a in arrays[:4])
    geom, cpack = pack_train(m2d, con, op, cols, tplan)
    img, alpha, done = train_forward(geom, cpack, tplan, 1e-4)
    nb = (tplan.tile_ends - tplan.tile_starts + 127) // 128
    assert bool((done <= nb).all()) and bool((done < nb).any()), "a tile exits early"
    assert int(nb.max()) > 1, "a tile walks several blocks"
    g = torch.from_numpy(r[..., :3]).contiguous()
    zeros = torch.zeros((H, W))
    rows = train_rows(geom, cpack, g, zeros, zeros, done, tplan)
    assert rows.shape == (tplan.T_padded, grad_row_width(3))
    none = torch.zeros_like(done)
    assert not train_rows(geom, cpack, g, zeros, zeros, none, tplan).any()
    busy = int(torch.argmax(done))
    start = int(tplan.padded_starts[busy])
    assert rows[start:start + 128].abs().sum() > 0
    assert K.LAUNCHES.train_fwd == 0 and K.LAUNCHES.train_bwd == 0


def _twin_rows(blocks=lambda done: done):
    """The twin's f32 rows and their magnitudes for one dense view (D = 20,
    early exits at 1e-4), the replayed block counts changed by ``blocks``."""
    arrays, r, s, _, tplan = _inputs(20, False, 16)
    geom, cpack = pack_train(*(torch.tensor(a) for a in arrays[:4]), tplan)
    img, alpha, done = train_forward(geom, cpack, tplan, 1e-4)
    g = torch.from_numpy(r)
    hterm = torch.from_numpy(s) * (1.0 - alpha)
    grem0 = (g * img).sum(-1)
    return train_rows_plain(geom, cpack, g, hterm, grem0, blocks(done), tplan,
                            magnitudes=True), done


def _light_row_dropped(rows, mags):
    """Zero the heaviest row that stays under 1e-4 of every column group's
    max: the group measure cannot see it."""
    a = rows[:, : 20 + GEOM_GRADS].abs()
    group_max = torch.cat([a[:, :20].max().expand(20), a[:, 20:].amax(0)])
    light = (a < 1e-4 * group_max).all(1) & (a.amax(1) > 0)
    assert light.any(), "the view has light rows"
    worst = torch.nonzero(light).squeeze(1)[a[light].amax(1).argmax()]
    bad = rows.clone()
    bad[worst] = 0.0
    return bad


def _last_block_not_replayed(rows, mags):
    (short, _), _ = _twin_rows(lambda done: (done - 1).clamp_min(0))
    return short


@pytest.mark.parametrize("mutate,group_blind", [(_light_row_dropped, True),
                                                (_last_block_not_replayed, False)])
def test_grad_rows_error_sees_wrong_rows_by_their_magnitude(mutate, group_blind):
    """``grad_rows_error``'s per-entry term (error over the entry's
    magnitude) catches a dropped light row, which its column-group term
    (error over the group's max) passes, and a replay one block short."""
    (rows, mags), _ = _twin_rows()
    assert grad_rows_error(rows, rows, 20, mags) == (0.0, 0.0, 0.0)
    _, of_group, of_entry = grad_rows_error(mutate(rows, mags), rows, 20, mags)
    group_tol, entry_tol = GRAD_ROWS_TOL[torch.float32]
    assert of_entry > 1e2 * entry_tol, of_entry
    assert (of_group <= group_tol) == group_blind, of_group


def test_magnitudes_bound_every_row_entry():
    """Each magnitude is the same sum over absolute values, so it bounds
    its entry (up to f32 rounding), and is zero where the row is padding."""
    (rows, mags), _ = _twin_rows()
    assert mags.shape == rows.shape and float(mags.max()) > 0
    assert bool((rows.abs() <= mags * (1 + 1e-5) + 1e-30).all())
    assert not bool(mags[:, 20 + GEOM_GRADS:].any())


@pytest.mark.parametrize("D,tile", [(20, 16), (3, 32)])
def test_f32_twin_within_its_magnitudes_of_an_f64_twin(D, tile):
    """The twin in f32 against itself in f64 stays within 1e-5 of each
    entry's magnitude, while a row's own largest value is no scale for
    its geometry gradients: there the same rounding reaches 10% of it
    (sums over pixels and ``v = grem - prefix`` cancel)."""
    arrays, r, s, _, tplan = _inputs(D, False, tile)
    geom, cpack = pack_train(*(torch.tensor(a) for a in arrays[:4]), tplan)
    img, alpha, done = train_forward(geom, cpack, tplan, 1e-4)
    g = torch.from_numpy(r[..., :D]).contiguous()
    hterm = torch.from_numpy(s) * (1.0 - alpha)
    grem0 = (g * img).sum(-1)
    rows, mags = train_rows_plain(geom, cpack, g, hterm, grem0, done, tplan, magnitudes=True)
    exact = train_rows_plain(*(x.double() for x in (geom, cpack, g, hterm, grem0)), done,
                             tplan, torch.float64)
    _, of_group, of_entry = grad_rows_error(rows, exact, D, mags)
    assert of_entry <= 1e-5 and of_group <= 1e-5, (of_group, of_entry)
    geo = slice(D, D + GEOM_GRADS)
    row_max = exact[:, geo].abs().amax(1).clamp_min(torch.finfo(torch.float32).tiny)
    of_row_max = float(((rows[:, geo] - exact[:, geo]).abs().amax(1) / row_max).max())
    assert of_row_max > 0.1, of_row_max
