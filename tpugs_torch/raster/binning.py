"""Tile grid and per-Gaussian tile rectangles. Counterpart:
``tpugs/raster/binning.py:34-64`` (``cdiv``, ``tile_grid``, ``tile_bbox``)."""

from __future__ import annotations

from typing import Tuple

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_grid(width: int, height: int, tile_size: int) -> Tuple[int, int]:
    return cdiv(width, tile_size), cdiv(height, tile_size)


def tile_bbox(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    valid: torch.Tensor,
    tile_size: int,
    n_tiles_x: int,
    n_tiles_y: int,
):
    """Inclusive-exclusive tile rectangle [tx0, tx1) x [ty0, ty1) covered by
    each Gaussian's radius square; invalid or zero-radius Gaussians cover
    nothing. Returns four int32 tensors."""
    x, y = means2d[..., 0], means2d[..., 1]
    r = radii
    ts = float(tile_size)

    def clip(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    tx0 = clip(torch.floor((x - r) / ts), n_tiles_x)
    ty0 = clip(torch.floor((y - r) / ts), n_tiles_y)
    tx1 = clip(torch.floor((x + r) / ts) + 1, n_tiles_x)
    ty1 = clip(torch.floor((y + r) / ts) + 1, n_tiles_y)
    empty = ~valid | (r <= 0)
    tx1 = torch.where(empty, tx0, tx1)
    ty1 = torch.where(empty, ty0, ty1)
    return tx0, ty0, tx1, ty1
