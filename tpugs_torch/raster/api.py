"""The public rasterisation API, gsplat-shaped. Counterpart:
``tpugs/raster/api.py`` (``RasterPlan``, ``plan_render``,
``rasterize_with_plan``, ``rasterize``).

* ``plan_render`` projects without gradient and builds the exact per-view
  ``Plan`` (``raster/plan.py``); the reference's size buckets
  (``bucket``, ``max_blocks``) change no result and have no counterpart.
* ``rasterize_with_plan`` is differentiable end to end: projection and SH
  in torch, then ``render_tiled`` (B4; B5 and B3 backward, no early exit),
  treating the plan's indices as constants.
* ``rasterize`` composes the two over a batch of cameras.

Everything runs on the device of the inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tpugs_torch.raster.colors import prepare_colors
from tpugs_torch.raster.plan import Plan, build_plan
from tpugs_torch.raster.projection import Projected, ProjectionConfig, project
from tpugs_torch.raster.tiled import TileConfig, render_tiled

RENDER_MODES = ("RGB", "D", "ED", "RGB+D", "RGB+ED")


@dataclasses.dataclass(frozen=True)
class RasterPlan:
    """The tile plan of one camera: the exact ``Plan``, the tile
    configuration it was built for and the projection (no gradient) it was
    built from, which ``rasterize``'s meta and ``accumulate_view`` reuse."""

    plan: Plan
    tile_config: TileConfig = TileConfig()
    proj: Optional[Projected] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def order(self) -> torch.Tensor:  # (N,) depth rank -> original index
        return self.plan.order

    @property
    def width(self) -> int:
        return self.plan.width

    @property
    def height(self) -> int:
        return self.plan.height

    @property
    def tile_size(self) -> int:
        return self.plan.tile_size


def plan_render(
    means, quats, scales, opacities, viewmat, K,
    width: int, height: int,
    proj_config: ProjectionConfig = ProjectionConfig(),
    tile_config: TileConfig = TileConfig(),
) -> RasterPlan:
    """The tile plan of one camera (no gradient)."""
    with torch.no_grad():
        proj = project(means, quats, scales, opacities, viewmat, K, width, height, proj_config)
        plan = build_plan(proj, width, height, tile_config.tile_size)
    return RasterPlan(plan, tile_config, proj)


def rasterize_with_plan(
    means, quats, scales, opacities,
    colors: torch.Tensor,  # (N, D) colours, or (N, K, 3) SH coefficients with sh_degree
    viewmat, K,
    plan: RasterPlan,
    sh_degree: Optional[int] = None,
    render_mode: str = "RGB",
    background: Optional[torch.Tensor] = None,  # (3,) or (D,) of the colours
    proj_config: ProjectionConfig = ProjectionConfig(),
    record: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image (H, W, D[+1]), alpha (H, W)) of one camera, differentiable in
    every tensor. ``render_mode`` is one of ``RENDER_MODES`` (ED: depth
    divided by alpha). The background applies to the colour channels and,
    as in the reference, after the ED divide. ``record``, a dict, receives
    the render's kernel inputs and outputs (``render_plan_train``)."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode {render_mode!r} not in {RENDER_MODES}")
    proj = project(means, quats, scales, opacities, viewmat, K, plan.width, plan.height,
                   proj_config)
    cols = prepare_colors(means, colors, viewmat, sh_degree)
    want_rgb = render_mode in ("RGB", "RGB+D", "RGB+ED")
    want_depth = render_mode != "RGB"
    chans = ([cols] if want_rgb else []) + ([proj.depths[:, None]] if want_depth else [])
    cols = torch.cat(chans, dim=-1) if len(chans) > 1 else chans[0]
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    image, alpha = render_tiled(proj.means2d, proj.conics, opac, cols, plan.plan,
                                plan.tile_config, record=record)
    if render_mode in ("RGB+ED", "ED"):
        d = image[..., -1:] / torch.clamp(alpha[..., None], min=1e-10)
        image = torch.cat([image[..., :-1], d], dim=-1) if want_rgb else d
    if background is not None and want_rgb:
        nrgb = image.shape[-1] - (1 if want_depth else 0)
        rgb = image[..., :nrgb] + (1.0 - alpha[..., None]) * background[None, None, :]
        image = torch.cat([rgb, image[..., nrgb:]], dim=-1) if want_depth else rgb
    return image, alpha


def rasterize(
    means, quats, scales, opacities,
    colors: torch.Tensor,
    viewmats, Ks,
    width: int, height: int,
    sh_degree: Optional[int] = None,
    render_mode: str = "RGB",
    backgrounds=None,  # (D,) for every camera or (C, D)
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
    antialiased: bool = False,
    tile_config: TileConfig = TileConfig(),
):
    """The gsplat-shaped entry point: ``viewmats`` (C, 4, 4) and ``Ks``
    (C, 3, 3) (or one camera's (4, 4), (3, 3)), on the device of
    ``means``. Returns (images (C, H, W, D), alphas (C, H, W, 1), meta)
    with meta ``means2d`` (C, N, 2), ``radii`` and ``depths`` (C, N) and
    ``plans`` (one ``RasterPlan`` per camera)."""
    proj_config = ProjectionConfig(eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
                                   radius_clip=radius_clip, antialiased=antialiased)
    dev = means.device
    viewmats = torch.as_tensor(viewmats, dtype=torch.float32, device=dev)
    Ks = torch.as_tensor(Ks, dtype=torch.float32, device=dev)
    if viewmats.ndim == 2:
        viewmats, Ks = viewmats[None], Ks[None]
    bgs = None if backgrounds is None else torch.as_tensor(
        backgrounds, dtype=torch.float32, device=dev)
    images, alphas, plans, means2d, radii, depths = [], [], [], [], [], []
    for c in range(viewmats.shape[0]):
        vm, K = viewmats[c], Ks[c]
        plan = plan_render(means, quats, scales, opacities, vm, K, width, height,
                           proj_config, tile_config)
        bg = None if bgs is None else (bgs[c] if bgs.ndim == 2 else bgs)
        img, alpha = rasterize_with_plan(means, quats, scales, opacities, colors, vm, K, plan,
                                         sh_degree, render_mode, bg, proj_config)
        images.append(img)
        alphas.append(alpha[..., None])
        plans.append(plan)
        means2d.append(plan.proj.means2d)
        radii.append(plan.proj.radii)
        depths.append(plan.proj.depths)
    meta = {"means2d": torch.stack(means2d), "radii": torch.stack(radii),
            "depths": torch.stack(depths), "plans": plans}
    return torch.stack(images), torch.stack(alphas), meta
