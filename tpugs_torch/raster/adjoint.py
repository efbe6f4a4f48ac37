"""Adjoint rasterisation: an image of pixel features -> per-Gaussian
blend-weighted sums. Counterpart: ``tpugs/raster/adjoint.py:35-156``
(``image_to_tiles``, ``backproject_tiled``).

For a render I(p) = sum_g w(g, p) c_g, the gradient of sum_p I(p) F(p) by
c_g is sum_p w(g, p) F(p): the feature numerator, and with F = 1 the
weight denominator. Here both come from one pass of B2 (the blend-weighted
rows with the ones-channel) at ``trans_eps=0``, the reference's walk of
every block, with f32 rows (the reference's ``Precision.HIGHEST``), summed
per Gaussian by B3.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tpugs_torch.raster.binning import tile_grid
from tpugs_torch.raster.kernels import adjoint_rows, reduce_rows
from tpugs_torch.raster.pack import pack_rows
from tpugs_torch.raster.plan import Plan
from tpugs_torch.raster.tiles import image_to_tiles

__all__ = ["image_to_tiles", "backproject_tiled"]


def backproject_tiled(
    means2d: torch.Tensor,  # (N, 2) original order
    conics: torch.Tensor,  # (N, 3)
    opacities: torch.Tensor,  # (N,) validity-masked
    feat_image: Optional[torch.Tensor],  # (H, W, D) pixel features, or None
    plan: Plan,
    record: Optional[dict] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(feat_sums (N, D) float32 or None, weight_sums (N,)) in original
    Gaussian order (the reference returns depth order):

        feat_sums[g] = sum_p w(g, p) feat_image[p],  weight_sums[g] = sum_p w(g, p)

    As in the reference's tiled path, p runs over every pixel of the tiles,
    including those of edge tiles outside W x H (zero features there): B2
    runs on ``plan`` widened to whole tiles. Without ``feat_image`` B2
    gets one zero channel (it takes D >= 1) and only the ones-column is
    kept. ``record``, a dict, receives B2's and B3's inputs and outputs
    (packed, feat_tiles, adjoint_plan, adjoint_rows, adjoint_sums)."""
    ts = plan.tile_size
    ntx, nty = tile_grid(plan.width, plan.height, ts)
    whole = dataclasses.replace(plan, width=ntx * ts, height=nty * ts)
    packed = pack_rows(means2d, conics, opacities, None, None, plan)
    if feat_image is None:
        feat_tiles = packed.new_zeros((plan.n_tiles, ts * ts, 1))
    else:
        feat_tiles = image_to_tiles(feat_image.float(), ts).contiguous()
    d = feat_tiles.shape[-1]
    rows = adjoint_rows(packed, feat_tiles, whole, trans_eps=0.0)
    sums = reduce_rows(rows, plan, d + 1)
    if record is not None:
        record.update(packed=packed, feat_tiles=feat_tiles, adjoint_plan=whole,
                      adjoint_rows=rows, adjoint_sums=sums)
    return (None if feat_image is None else sums[:, :d]), sums[:, d]
