"""Per-view drivers of the kernels. Counterparts:
``tpugs/raster/pallas_tiled.py:2255`` (``render_view_pallas``) and
``:2310`` (``backproject_view_pallas``), single-pass with the
ones-channel: the multi-chunk ``d_chunk`` path is not needed because the
adjoint kernel slices channels internally, so the reduce engine is honoured
at every D.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.kernels import (
    TRANS_EPS,
    adjoint_rows,
    adjoint_scatter_rows,
    reduce_rows,
    reduce_striped,
    render_tiles,
)
from tpugs_torch.raster.pack import pack_isect_all
from tpugs_torch.raster.plan import Plan
from tpugs_torch.raster.projection import ProjectionConfig, project
from tpugs_torch.raster.tiles import tiles_to_image


def render_view(
    means, quats, scales, opacities,
    colors: torch.Tensor,  # (N, 3) direct colours or (N, K, 3) SH coefficients
    viewmat, K,
    plan: Plan,
    sh_degree: Optional[int] = None,
    proj_config: ProjectionConfig = ProjectionConfig(),
    trans_eps: float = TRANS_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RGB render of one camera: (image (H, W, 3), alpha (H, W))."""
    proj = project(means, quats, scales, opacities, viewmat, K,
                   plan.width, plan.height, proj_config)
    packed = pack_isect_all(proj, prepare_colors(means, colors, viewmat, sh_degree), plan)
    tiles, _ = render_tiles(packed, plan, trans_eps)
    img = tiles_to_image(tiles, plan.width, plan.height, plan.tile_size)
    return img[..., :3], img[..., 4]


# Reduce engines of the port: "pallas" (the reference's default name: B2's
# plan-order rows, then B3) and "scatter" (B6 writes the rows striped, B7
# sums the stripes; the plan must be built with scatter=True).
REDUCE_ENGINES = ("pallas", "scatter")


def contribution_sums(
    packed: torch.Tensor,
    feat_tiles: torch.Tensor,  # (n_tiles, ts*ts, D), float32 or bfloat16
    plan: Plan,
    trans_eps: float = TRANS_EPS,
    on_stage: Optional[Callable[[str], None]] = None,
    reduce_engine: str = "pallas",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused adjoint of one camera on the tile layout: (contribution
    rows, sums (N, D + 1) float32 in original Gaussian order). With
    ``reduce_engine`` "pallas" the rows are B2's (T_padded, width) in plan
    order, summed by B3; with "scatter" they are B6's striped buffer
    (R_striped + 1, width), summed by B7, and the sums are bit-equal. The
    sums hold the features, then the weight denominator from the
    ones-channel at column D; ``split_sums`` parts them. Pixels outside the
    image carry zero weight, so uncropped tile features are fine.
    ``on_stage`` is called after "adjoint" and "reduce"; an engine the
    port lacks raises ("xla": NotImplementedError)."""
    if reduce_engine == "xla":
        raise NotImplementedError(
            'reduce_engine="xla" (the XLA reduce_contribs) is not ported yet '
            "(ROADMAP item 5); use one of " + ", ".join(REDUCE_ENGINES))
    if reduce_engine not in REDUCE_ENGINES:
        raise ValueError(
            f"unknown reduce_engine {reduce_engine!r}; the port has "
            + ", ".join(REDUCE_ENGINES))
    mark = on_stage or (lambda name: None)
    n_cols = feat_tiles.shape[-1] + 1
    if reduce_engine == "scatter":
        rows = adjoint_scatter_rows(packed, feat_tiles, plan, trans_eps)
        mark("adjoint")
        sums = reduce_striped(rows, plan, n_cols)
    else:
        rows = adjoint_rows(packed, feat_tiles, plan, trans_eps)
        mark("adjoint")
        sums = reduce_rows(rows, plan, n_cols)
    mark("reduce")
    return rows, sums


def split_sums(sums: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feat_sums (N, D), weight_sums (N,)) of ``contribution_sums``."""
    return sums[:, :-1], sums[:, -1]


def backproject_view(
    packed: torch.Tensor,
    feat_tiles: torch.Tensor,
    plan: Plan,
    trans_eps: float = TRANS_EPS,
    reduce_engine: str = "pallas",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feat_sums (N, D), weight_sums (N,)) of one camera; see
    ``contribution_sums``."""
    return split_sums(contribution_sums(packed, feat_tiles, plan, trans_eps,
                                        reduce_engine=reduce_engine)[1])
