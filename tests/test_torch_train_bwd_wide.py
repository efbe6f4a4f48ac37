"""B5 above 256 channels, on the CPU: the layout that each width and tile
selects, the C side's limits, and the plain decomposition that the card's
two launches follow.

* ``train_layout`` gives the cluster kernel up to ``CLUSTER_MAX_CHANNELS``
  and, above it up to ``MAX_CHANNELS``, colour slices of the cluster
  kernel's ranks (``fwd_slices`` at ``COLOUR_SLICE_CHANNELS``) plus the
  geometry cluster kernel; ``geom_cluster`` gives that kernel up to
  ``GEOM_CLUSTER_MAX_CHANNELS`` and None above (the one-CTA geometry
  kernel); other tiles and widths raise.
* The limits named in ``raster/train.py`` are the constants of
  ``csrc/train_bwd.cu``, and the geometry kernel's shared memory at the cap
  fits a CTA while one channel more does not.
* The colour-only twins of the slices, each on its own columns of the
  colours and of g, plus the geometry-only twin over all channels,
  assembled into rows with zero pad columns, equal ``train_rows_plain``
  within 1e-6 of each column group's maximum, in f32 and bf16.
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
    GEOM_CLUSTER_MAX_CHANNELS,
    GEOM_GRADS,
    GEOM_PIXELS_PER_RANK,
    MAX_CHANNELS,
    PIXELS_PER_RANK,
    fwd_slices,
    geom_cluster,
    grad_row_width,
    pack_train,
    train_forward_plain,
    train_layout,
    train_rows_plain,
)
from tpugs_torch.utils.synthetic import orbit_cameras, random_scene

SOURCE = Path(__file__).resolve().parents[1] / "tpugs_torch" / "csrc" / "train_bwd.cu"
CAP = GEOM_CLUSTER_MAX_CHANNELS
SMEM_PER_CTA = 232_448  # a Hopper CTA's shared memory (227 KB), static bytes included
STATIC_BYTES = 6 * 128 * 4  # the block's geometry (BlockGeom)


@pytest.mark.parametrize("d", [1, 3, 256, 257, 300, 512, CAP, CAP + 1])
@pytest.mark.parametrize("ts", [16, 32])
def test_layout_by_width_and_tile(ts, d):
    geom = geom_cluster(ts, d)
    if d > CAP:
        assert geom is None
    else:
        assert geom == (ts * ts // GEOM_PIXELS_PER_RANK, GEOM_PIXELS_PER_RANK)
        assert geom[0] == {16: 4, 32: 16}[ts]
    if d > MAX_CHANNELS:
        with pytest.raises(ValueError):
            train_layout(ts, d)
        return
    layout = train_layout(ts, d)
    c = ts * ts // PIXELS_PER_RANK
    if d <= CLUSTER_MAX_CHANNELS:
        assert layout == {"cluster": (c, PIXELS_PER_RANK)}
        return
    assert set(layout) == {"colour", "geom"} and layout["geom"] == geom
    _, _, s, ns = layout["colour"]
    assert layout["colour"] == (c, PIXELS_PER_RANK) + fwd_slices(d, COLOUR_SLICE_CHANNELS)
    assert s == -(-d // COLOUR_SLICE_CHANNELS) and ns % 16 == 0 and ns <= COLOUR_SLICE_CHANNELS
    assert (s - 1) * ns < d <= s * ns


@pytest.mark.parametrize("call", [
    lambda: train_layout(8, 300), lambda: train_layout(64, 3), lambda: train_layout(16, 0),
    lambda: train_layout(32, MAX_CHANNELS + 1), lambda: geom_cluster(24, 5),
    lambda: geom_cluster(16, 0)])
def test_layout_refuses(call):
    with pytest.raises(ValueError):
        call()


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def _geom_bytes(d):
    """The geometry kernel's dynamic shared memory (GeomLayout::bytes)."""
    d4 = -(-d // 4) * 4
    ldg = d4 if (d4 // 4) % 2 else d4 + 4
    kc = _constant("kKC")
    return 4 * (GEOM_PIXELS_PER_RANK * ldg + 2 * 32 * (kc + 4) + GEOM_PIXELS_PER_RANK * 36
                + 2 * 32 * (GEOM_PIXELS_PER_RANK + 5) + 128 * GEOM_GRADS)


def test_c_side_limits_are_the_python_ones():
    assert _constant("kMaxGeomD") == GEOM_CLUSTER_MAX_CHANNELS
    assert _constant("kGPix") == GEOM_PIXELS_PER_RANK
    assert _constant("kMaxSliceD") == _constant("kMaxClusterD") == CLUSTER_MAX_CHANNELS
    assert COLOUR_SLICE_CHANNELS <= CLUSTER_MAX_CHANNELS
    assert _geom_bytes(CAP) + STATIC_BYTES <= SMEM_PER_CTA
    assert all(_geom_bytes(d) + STATIC_BYTES > SMEM_PER_CTA for d in range(CAP + 1, CAP + 9))


W, H, N = 64, 48, 600


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
@pytest.mark.parametrize("d", [300, 512])
def test_slices_and_geometry_assemble_the_rows(d, ts, dtype):
    geom, cols, g, hterm, grem0, done, plan = _bwd_inputs(d, ts)
    full = train_rows_plain(geom, cols, g, hterm, grem0, done, plan, dtype)
    rw = grad_row_width(d)
    assert full.shape == (plan.T_padded, rw)
    _, _, s, ns = train_layout(ts, d)["colour"]
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
