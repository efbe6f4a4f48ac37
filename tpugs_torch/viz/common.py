"""Shared visualisation helpers. Counterpart: ``tpugs/viz/common.py``."""

from __future__ import annotations

import numpy as np
import torch


def create_checkerboard(width: int, height: int, size: int = 64) -> np.ndarray:
    """White/grey checkerboard background, (H, W, 3) uint8."""
    yy, xx = np.mgrid[0:height, 0:width]
    cells = ((xx // size) + (yy // size)) % 2 == 0
    board = np.where(cells, 255, 128).astype(np.uint8)
    return np.repeat(board[..., None], 3, axis=-1)


def uint8_image(img) -> torch.Tensor:
    """A [0, 1] float image (tensor or array) to uint8 where it lies: clip,
    x255, then the cast, which truncates."""
    return (torch.as_tensor(img).clamp(0, 1) * 255).to(torch.uint8)


def to_uint8(img) -> np.ndarray:
    """``uint8_image`` on the host."""
    return uint8_image(img).cpu().numpy()
