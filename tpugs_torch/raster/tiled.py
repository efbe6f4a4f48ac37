"""Per-view calls of the kernels and the differentiable tiled render.
Counterparts: ``tpugs/raster/pallas_tiled.py:2255`` (``render_view_pallas``)
and ``:2310`` (``backproject_view_pallas``), single-pass with the
ones-channel: the multi-chunk ``d_chunk`` path is not needed because the
adjoint kernel slices channels internally, so the reduce engine is honoured
at every D; and ``tpugs/raster/tiled.py:62-468`` (``TileConfig``,
``render_tiled``, ``render_tiled_autodiff``, ``required_blocks``).

The reference's tiled path walks every block of every tile (no early
exit), so ``render_tiled`` is the train render (B4 forward; B5, then B3,
backward) at ``trans_eps=0``. ``render_tiled_autodiff`` is the same walk in
plain torch under autograd, the oracle of the analytic backward.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tpugs_torch.raster.binning import cdiv
from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.kernels import (
    TRANS_EPS,
    _tile_pixels,
    adjoint_rows,
    adjoint_scatter_rows,
    reduce_rows,
    reduce_striped,
    render_tiles,
)
from tpugs_torch.raster.naive import evaluate_alpha
from tpugs_torch.raster.pack import pack_isect_all
from tpugs_torch.raster.plan import Plan
from tpugs_torch.raster.projection import ProjectionConfig, project
from tpugs_torch.raster.reduce import reduce_contribs_xla
from tpugs_torch.raster.tiles import tiles_to_image
from tpugs_torch.raster.train import render_plan_train
from tpugs_torch.utils.profiling import annotation


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
# plan-order rows, then B3), "scatter" (B6 writes the rows striped, B7
# sums the stripes; the plan must be built with scatter=True) and "xla"
# (B2's rows, then the slot-table gather of raster/reduce.py).
REDUCE_ENGINES = ("pallas", "scatter", "xla")


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
    image carry zero weight, so uncropped tile features are fine. With
    "xla" the rows are B2's, summed by ``reduce_contribs_xla`` (equal to
    B3's sums to float rounding). ``on_stage`` is called after "adjoint"
    and "reduce", which are also the trace's spans ``tpugs.lift.adjoint``
    and ``tpugs.lift.reduce``."""
    if reduce_engine not in REDUCE_ENGINES:
        raise ValueError(
            f"unknown reduce_engine {reduce_engine!r}; the port has "
            + ", ".join(REDUCE_ENGINES))
    mark = on_stage or (lambda name: None)
    n_cols = feat_tiles.shape[-1] + 1
    adjoint = adjoint_scatter_rows if reduce_engine == "scatter" else adjoint_rows
    reduce = {"scatter": reduce_striped, "xla": reduce_contribs_xla}.get(reduce_engine,
                                                                         reduce_rows)
    with annotation("tpugs.lift.adjoint"):
        rows = adjoint(packed, feat_tiles, plan, trans_eps)
    mark("adjoint")
    with annotation("tpugs.lift.reduce"):
        sums = reduce(rows, plan, n_cols)
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


# ------------------------------------------------ the differentiable path


class TileConfig(NamedTuple):
    tile_size: int = 16  # pixels per tile edge (the card's kernels take any)
    block_size: int = 128  # Gaussians per block of render_tiled_autodiff's walk
    tiles_per_chunk: int = 32  # tiles per step of render_tiled_autodiff's walk


def check_tile_config(config: TileConfig, plan: Optional[Plan] = None) -> None:
    if plan is not None and plan.tile_size != config.tile_size:
        raise ValueError(f"plan of tile {plan.tile_size}, TileConfig of {config.tile_size}")


def render_tiled(
    means2d: torch.Tensor,  # (N, 2) original order
    conics: torch.Tensor,  # (N, 3)
    opacities: torch.Tensor,  # (N,) validity-masked
    colors: torch.Tensor,  # (N, D), any D
    plan: Plan,
    config: TileConfig = TileConfig(),
    background: Optional[torch.Tensor] = None,  # (D,)
    abs_probe: Optional[torch.Tensor] = None,  # (N, 2) zeros
    on_stage: Optional[Callable[[str], None]] = None,
    record: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image (H, W, D), alpha (H, W)) of one camera, differentiable in
    every input. Unlike the reference's, the inputs are in original
    Gaussian order: ``plan`` (``build_plan``) holds the depth order.

    The train render (``render_plan_train``) with no early exit
    (``trans_eps=0``) and f32 gradient rows. ``config.tile_size`` must be
    the plan's; ``block_size`` and ``tiles_per_chunk`` are the reference's
    TPU layout knobs and do not change the result. Any tile and any width
    render and differentiate, on the card through each kernel
    (``RenderTrain``) at any tile up to ``GEOM_MAX_CHANNELS``.
    ``abs_probe``'s gradient is the absgrad statistic; ``on_stage`` and
    ``record`` as in ``render_plan_train``."""
    check_tile_config(config, plan)
    return render_plan_train(means2d, conics, opacities, colors, plan, background,
                             trans_eps=0.0, abs_probe=abs_probe, contrib_dtype=torch.float32,
                             on_stage=on_stage, record=record)


def _render_tiles_autodiff(means2d, conics, opacities, colors, plan: Plan,
                           config: TileConfig):
    """The reference's ``_render_tiles`` walk over ``plan``'s spans:
    (images (n_tiles, ts*ts, D), T (n_tiles, ts*ts)), differentiable."""
    ts, B, TC = config.tile_size, config.block_size, config.tiles_per_chunk
    dev = means2d.device
    n, d = colors.shape
    order = plan.order
    m2d = torch.cat([means2d[order], means2d.new_zeros((1, 2))])
    con = torch.cat([conics[order], conics.new_ones((1, 3))])
    opa = torch.cat([opacities[order], opacities.new_zeros((1,))])
    col = torch.cat([colors[order], colors.new_zeros((1, d))])
    gid_of = torch.cat([plan.padded_gid.long(), torch.full((1,), n, device=dev)])
    spans = (plan.tile_ends - plan.tile_starts).long()
    starts = plan.padded_starts.long()
    ntx, _ = plan.grid
    n_blocks = required_blocks(plan, B)
    lane = torch.arange(B, device=dev)
    imgs, transs = [], []
    for c0 in range(0, plan.n_tiles, TC):
        tiles = torch.arange(c0, min(c0 + TC, plan.n_tiles), device=dev)
        px, py = _tile_pixels(tiles, ntx, ts)
        img = torch.zeros((len(tiles), ts * ts, d), dtype=torch.float32, device=dev)
        trans = torch.ones((len(tiles), ts * ts), dtype=torch.float32, device=dev)
        for b in range(n_blocks):
            j = b * B + lane
            in_span = j[None, :] < spans[tiles, None]
            slot = torch.where(in_span, starts[tiles, None] + j, plan.T_padded)
            gid = gid_of[slot]  # (k, B)
            dx = px[:, None, :] - m2d[gid, 0][..., None]
            dy = py[:, None, :] - m2d[gid, 1][..., None]
            alpha = evaluate_alpha(con[gid][:, :, None, :], opa[gid][..., None], dx, dy)
            alpha = torch.where(in_span[..., None], alpha, torch.zeros_like(alpha))
            cum = torch.cumprod(1.0 - alpha, dim=1)
            texc = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
            w = alpha * texc * trans[:, None, :]
            img = img + torch.einsum("tbp,tbd->tpd", w, col[gid])
            trans = trans * cum[:, -1]
        imgs.append(img)
        transs.append(trans)
    return torch.cat(imgs), torch.cat(transs)


def render_tiled_autodiff(
    means2d, conics, opacities, colors, plan: Plan,
    config: TileConfig = TileConfig(),
    background: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``render_tiled`` by plain autograd through the block walk of
    ``_render_tiles`` (``tpugs/raster/tiled.py:81-172``): the gradient
    oracle of ``render_tiled``'s analytic backward, on the CPU and at test
    scale only (its backward keeps every block's interiors). Here
    ``block_size`` and ``tiles_per_chunk`` set the walk's granularity."""
    check_tile_config(config, plan)
    imgs, transs = _render_tiles_autodiff(means2d, conics, opacities, colors, plan, config)
    if background is not None:
        imgs = imgs + transs[..., None] * background
    w, h, ts = plan.width, plan.height, plan.tile_size
    alpha = tiles_to_image((1.0 - transs)[..., None], w, h, ts)[..., 0]
    return tiles_to_image(imgs, w, h, ts), alpha


def required_blocks(plan: Plan, block_size: int) -> int:
    """Blocks of ``block_size`` Gaussians that the longest span needs."""
    spans = plan.tile_ends - plan.tile_starts
    return max(1, cdiv(int(spans.max()) if spans.numel() else 0, block_size))
