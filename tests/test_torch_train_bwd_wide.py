"""B5 above 256 channels, on the CPU: the layout that each width and tile
selects, the C side's limits, and the plain decomposition that the card's
two launches follow.

* ``train_layout`` gives the cluster kernel up to ``CLUSTER_MAX_CHANNELS``
  and, above it up to ``GEOM_MAX_CHANNELS``, colour slices of the cluster
  kernel's ranks (``fwd_slices`` at ``COLOUR_SLICE_CHANNELS``) plus the
  geometry cluster kernel; ``geom_cluster`` gives that kernel's (C, P, G)
  at every width: P pixels a rank by ``GEOM_WIDTHS`` (64 up to 700
  channels, 32 up to 1276, 16 up to 2108, 8 up to 4276, 4 up to 8620, 2
  up to 18460, 1 up to 38140), clusters of C = min(ts*ts / P, 16) CTAs at
  tiles 16 and 32, G pixel groups; tile 0, widths below 1 and above the
  cap raise, the card's layout naming the cap.
* The limits named in ``raster/train.py`` are the constants of
  ``csrc/train_bwd.cu``; the geometry kernel's shared memory at each
  width's P fits a CTA, and one channel past a width does not at its P
  (so P is the largest that fits).
* The colour-only twins of the slices, each on its own columns of the
  colours and of g, plus the geometry-only twin over all channels,
  assembled into rows with zero pad columns, equal ``train_rows_plain``
  within 1e-6 of each column group's maximum, in f32 and bf16, at widths
  of one and of two pixel groups.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpugs_torch.raster.plan import build_plan
from tpugs_torch.raster.projection import project
from tpugs_torch.raster.train import (
    CLUSTER_MAX_CHANNELS,
    COLOUR_SLICE_CHANNELS,
    GEOM_GRADS,
    GEOM_MAX_CHANNELS,
    GEOM_MAX_CLUSTER,
    GEOM_WIDTHS,
    PIXELS_PER_RANK,
    fwd_slices,
    geom_cluster,
    grad_row_width,
    pack_train,
    train_cluster,
    train_forward_plain,
    train_layout,
    train_rows,
    train_rows_plain,
)
from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

SOURCE = Path(__file__).resolve().parents[1] / "tpugs_torch" / "csrc" / "train_bwd.cu"
CAP = GEOM_MAX_CHANNELS
SMEM_PER_CTA = 232_448  # a Hopper CTA's shared memory (227 KB), static bytes included
STATIC_BYTES = 6 * 128 * 4  # the block's geometry (BlockGeom)
# (widest D, (C, P, G)) of the geometry kernel by tile
GEOM_LAYOUTS = {16: ((700, (4, 64, 1)), (1276, (8, 32, 1)), (2108, (16, 16, 1)),
                     (4276, (16, 8, 2)), (8620, (16, 4, 4)), (18460, (16, 2, 8)),
                     (38140, (16, 1, 16))),
                32: ((700, (16, 64, 1)), (1276, (16, 32, 2)), (2108, (16, 16, 4)),
                     (4276, (16, 8, 8)), (8620, (16, 4, 16)), (18460, (16, 2, 32)),
                     (38140, (16, 1, 64)))}


@pytest.mark.parametrize("d", [1, 3, 256, 257, 300, 512, 700, 701, 1027, 1276, 1277, 2051,
                               2108, 2109, 4096, 4097, 8620, 8621, 18461, CAP])
@pytest.mark.parametrize("ts", [16, 32])
def test_layout_by_width_and_tile(ts, d):
    geom = geom_cluster(ts, d)
    assert geom == next(want for widest, want in GEOM_LAYOUTS[ts] if d <= widest)
    c, p, g = geom
    assert c * p * g == ts * ts and c == min(ts * ts // p, GEOM_MAX_CLUSTER)
    layout = train_layout(ts, d)
    c = ts * ts // PIXELS_PER_RANK
    if d <= CLUSTER_MAX_CHANNELS:
        assert layout == {"cluster": (c, PIXELS_PER_RANK, 1)}
        return
    assert set(layout) == {"colour", "geom"} and layout["geom"] == geom
    _, _, _, s, ns = layout["colour"]
    assert layout["colour"] == (c, PIXELS_PER_RANK, 1) + fwd_slices(d, COLOUR_SLICE_CHANNELS)
    assert s == -(-d // COLOUR_SLICE_CHANNELS) and ns % 16 == 0 and ns <= COLOUR_SLICE_CHANNELS
    assert (s - 1) * ns < d <= s * ns


@pytest.mark.parametrize("call", [
    lambda: train_layout(0, 300), lambda: train_layout(-1, 3), lambda: train_layout(16, 0),
    lambda: train_layout(32, CAP + 1), lambda: geom_cluster(0, 5),
    lambda: geom_cluster(16, 0), lambda: geom_cluster(32, CAP + 1),
    lambda: train_cluster(16, CAP + 1)])
def test_layout_refuses(call):
    with pytest.raises(ValueError):
        call()


def test_train_rows_names_the_cap():
    """The card's layout (what ``train_rows`` calls on a CUDA tensor, before
    any launch) names the cap; the twin on the CPU takes the width."""
    geom, cols, g, hterm, grem0, done, plan = _bwd_inputs(3, 16)
    with pytest.raises(ValueError, match=f"GEOM_MAX_CHANNELS = {CAP}"):
        train_layout(plan.tile_size, CAP + 1)
    rows = train_rows(geom, torch.cat([cols, cols.new_zeros((plan.T_padded, 2))], 1),
                      torch.cat([g, g.new_zeros((H, W, 2))], -1), hterm, grem0, done, plan)
    assert rows.shape == (plan.T_padded, grad_row_width(5))


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def _c_widths():
    m = re.search(r"constexpr int kGeomWidths\[7\]\[2\] = \{(.*?)\};", SOURCE.read_text(),
                  re.S)
    assert m
    return tuple(tuple(int(x) for x in pair) for pair in re.findall(r"\{(\d+), (\d+)\}", m[1]))


def _geom_bytes(p, d):
    """The geometry kernel's dynamic shared memory at P = p (GeomLayout<P>::
    bytes): g, two chunks of K KS colour columns (K = 256 / (8 p / JP)
    splits, JP = min(p, 4)), the u buffers (one at K = 2), d sigma and d
    op, the block's partial sums."""
    d4 = -(-d // 4) * 4
    ldg = d4 if (d4 // 4) % 2 else d4 + 4
    k = 256 // (8 * (p // min(p, 4)))
    kc = k * (32 if p >= 16 else 16 if p == 8 else 8)
    return 4 * (p * ldg + 2 * 32 * (kc + 4) + (1 if k == 2 else k) * p * 36
                + 2 * 32 * (p + 5) + 128 * GEOM_GRADS)


def test_c_side_limits_are_the_python_ones():
    assert _c_widths() == GEOM_WIDTHS
    assert _constant("kMaxGeomD") == GEOM_MAX_CHANNELS == GEOM_WIDTHS[-1][0]
    assert _constant("kMaxGeomCluster") == GEOM_MAX_CLUSTER
    assert _constant("kGeomSmem") + STATIC_BYTES == SMEM_PER_CTA
    assert _constant("kMaxSliceD") == _constant("kMaxClusterD") == CLUSTER_MAX_CHANNELS
    assert COLOUR_SLICE_CHANNELS <= CLUSTER_MAX_CHANNELS
    for widest, p in GEOM_WIDTHS:
        assert _geom_bytes(p, widest) + STATIC_BYTES <= SMEM_PER_CTA, p
        if widest < CAP:  # the next width needs the smaller P
            assert all(_geom_bytes(p, d) + STATIC_BYTES > SMEM_PER_CTA
                       for d in range(widest + 1, widest + 9)), p


W, H, N = 40, 32, 150


def _bwd_inputs(d, ts):
    scene = random_scene(N, seed=3, extent=1.0, scale_range=(0.08, 0.25), device="cpu")
    cams = orbit_cameras(1, W, H, radius=2.5, device="cpu")
    proj = project(scene.means, scene.quats, scene.scales, scene.opacities, cams.viewmats[0],
                   cams.Ks[0], W, H)
    plan = build_plan(proj, W, H, ts)
    rng = np.random.default_rng(d + ts)
    colors = torch.from_numpy(rng.uniform(0, 1, (N, d)).astype(np.float32))
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    geom, cols = pack_train(proj.means2d, proj.conics, opac, colors, plan)
    img, alpha, done = train_forward_plain(geom, cols, plan)
    g = torch.from_numpy(rng.normal(0, 1, (H, W, d)).astype(np.float32))
    hterm = torch.from_numpy(rng.normal(0, 1, (H, W)).astype(np.float32)) * (1.0 - alpha)
    grem0 = (g * img).sum(-1)
    return geom, cols, g, hterm, grem0, done, plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("d", [300, 512, 1027])
def test_slices_and_geometry_assemble_the_rows(d, ts, dtype):
    geom, cols, g, hterm, grem0, done, plan = _bwd_inputs(d, ts)
    full = train_rows_plain(geom, cols, g, hterm, grem0, done, plan, dtype)
    rw = grad_row_width(d)
    assert full.shape == (plan.T_padded, rw)
    _, _, _, s, ns = train_layout(ts, d)["colour"]
    rows = torch.zeros((plan.T_padded, rw), dtype=dtype)
    for a in range(0, s * ns, ns):
        b = min(a + ns, d)
        rows[:, a:b] = train_rows_plain(geom, cols[:, a:b].contiguous(),
                                        g[..., a:b].contiguous(), hterm, grem0, done, plan,
                                        dtype, colour_only=True)
    rows[:, d:d + GEOM_GRADS] = train_rows_plain(geom, cols, g, hterm, grem0, done, plan, dtype,
                                                 geometry_only=True)
    assert not full[:, d + GEOM_GRADS:].any()
    full, rows = full.float(), rows.float()
    for grp in [slice(0, d)] + [slice(d + j, d + j + 1) for j in range(GEOM_GRADS)]:
        scale = float(full[:, grp].abs().max())
        assert scale > 0
        assert float((rows[:, grp] - full[:, grp]).abs().max()) <= 1e-6 * scale, grp


def test_the_twin_takes_one_column_group_at_a_time():
    args = _bwd_inputs(3, 16)
    with pytest.raises(ValueError, match="exclude"):
        train_rows_plain(*args, geometry_only=True, colour_only=True)
    assert train_rows_plain(*args, colour_only=True).shape == (args[-1].T_padded, 3)
