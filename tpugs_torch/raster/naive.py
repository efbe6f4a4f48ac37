"""The dense differentiable renderer, the correctness oracle. Counterpart:
``tpugs/raster/naive.py:29-170``.

O(N x pixels) memory and work: the full per-Gaussian, per-pixel alpha
matrix, composited with an exclusive cumprod along the depth-sorted
Gaussian axis. Plain torch whose autograd is easy to trust; only for tiny
scenes. It runs on the device of its inputs and is no kernel twin: the
tiled renderers (``raster/tiled.py``, the kernels) are tested against it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpugs_torch.raster.binning import tile_bbox, tile_grid
from tpugs_torch.raster.projection import Projected, ProjectionConfig, project, view_directions
from tpugs_torch.raster.sh import sh_to_color

ALPHA_CLIP_MIN = 1.0 / 255.0
ALPHA_CLIP_MAX = 0.999


def pixel_centers(width: int, height: int, device=None) -> torch.Tensor:
    """(H, W, 2) pixel-centre coordinates (x + 0.5, y + 0.5)."""
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xg, yg], dim=-1)


def evaluate_alpha(conics: torch.Tensor, opacities: torch.Tensor, dx: torch.Tensor,
                   dy: torch.Tensor) -> torch.Tensor:
    """alpha = min(0.999, o * exp(-max(sigma, 0))), zeroed unless sigma >= 0
    and alpha >= 1/255; the reference's order of operations, so that a
    Gaussian at the clip falls on the same side."""
    a, b, c = conics[..., 0], conics[..., 1], conics[..., 2]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = opacities * torch.exp(-torch.clamp(sigma, min=0.0))
    alpha = torch.clamp(alpha, max=ALPHA_CLIP_MAX)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(sigma >= 0.0, alpha, zero)
    return torch.where(alpha >= ALPHA_CLIP_MIN, alpha, zero)


def gaussian_alphas(proj: Projected, width: int, height: int,
                    tile_size: int = 16) -> torch.Tensor:
    """(N, H*W) per-Gaussian per-pixel alpha, clipped and masked, and zero
    outside the tiles of each Gaussian's bbox (the tiled renderers'
    coverage)."""
    ntx, nty = tile_grid(width, height, tile_size)
    px = pixel_centers(width, height, proj.means2d.device).reshape(-1, 2)
    d = px[None, :, :] - proj.means2d[:, None, :]
    alpha = evaluate_alpha(proj.conics[:, None, :], proj.opacities[:, None], d[..., 0], d[..., 1])
    alpha = torch.where(proj.valid[:, None], alpha, torch.zeros_like(alpha))
    tx0, ty0, tx1, ty1 = tile_bbox(proj.means2d, proj.radii, proj.valid, tile_size, ntx, nty)
    ptx = torch.div(px[:, 0], tile_size, rounding_mode="floor").to(torch.int32)
    pty = torch.div(px[:, 1], tile_size, rounding_mode="floor").to(torch.int32)
    covered = ((ptx[None, :] >= tx0[:, None]) & (ptx[None, :] < tx1[:, None])
               & (pty[None, :] >= ty0[:, None]) & (pty[None, :] < ty1[:, None]))
    return torch.where(covered, alpha, torch.zeros_like(alpha))


def composite(alphas_sorted: torch.Tensor, colors_sorted: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Front-to-back compositing of (N, P) alphas in depth order with (N, D)
    colours: (image (P, D), alpha (P,), weights (N, P)), where
    weights[g, p] = alpha_g(p) * prod over g' before g of (1 - alpha_g'(p))."""
    one_minus = 1.0 - alphas_sorted
    trans_excl = torch.cumprod(one_minus, dim=0) / torch.clamp(one_minus, min=1e-12)
    weights = alphas_sorted * trans_excl
    image = torch.einsum("np,nd->pd", weights, colors_sorted)
    return image, weights.sum(0), weights


def render_naive(
    means, quats, scales, opacities,
    colors: torch.Tensor,  # (N, D) per-Gaussian colours (post-SH or raw)
    viewmat, K, width: int, height: int,
    background: Optional[torch.Tensor] = None,
    config: ProjectionConfig = ProjectionConfig(),
    tile_size: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view, densely: (image (H, W, D), alpha (H, W))."""
    proj = project(means, quats, scales, opacities, viewmat, K, width, height, config)
    inf = torch.full_like(proj.depths, float("inf"))
    order = torch.sort(torch.where(proj.valid, proj.depths, inf), stable=True).indices
    alphas = gaussian_alphas(Projected(*[x[order] for x in proj]), width, height, tile_size)
    image, alpha_out, _ = composite(alphas, colors[order])
    if background is not None:
        image = image + (1.0 - alpha_out)[:, None] * background[None, :]
    return image.reshape(height, width, colors.shape[-1]), alpha_out.reshape(height, width)


def render_naive_sh(
    means, quats, scales, opacities,
    sh_coeffs: torch.Tensor,  # (N, K, 3)
    viewmat, K, width: int, height: int, sh_degree: int,
    background: Optional[torch.Tensor] = None,
    config: ProjectionConfig = ProjectionConfig(),
    tile_size: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``render_naive`` of the SH colours seen from ``viewmat``."""
    colors = sh_to_color(sh_coeffs, view_directions(means, viewmat), sh_degree)
    return render_naive(means, quats, scales, opacities, colors, viewmat, K, width, height,
                        background, config, tile_size)
