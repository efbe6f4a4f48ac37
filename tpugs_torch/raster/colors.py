"""Per-Gaussian colours for the render pass. Counterpart:
``tpugs/raster/api.py:130-139`` (``_prepare_colors``)."""

from __future__ import annotations

from typing import Optional

import torch

from tpugs_torch.raster.projection import view_directions
from tpugs_torch.raster.sh import sh_to_color


def prepare_colors(
    means: torch.Tensor,
    colors: torch.Tensor,
    viewmat: torch.Tensor,
    sh_degree: Optional[int],
) -> torch.Tensor:
    """(N, D) colours; SH-evaluated from (N, K, 3) coefficients if
    ``sh_degree`` is given, else passed through ((N, 1, 3) -> (N, 3))."""
    if sh_degree is None:
        if colors.ndim == 3:
            colors = colors[:, 0, :]
        return colors
    return sh_to_color(colors, view_directions(means, viewmat), sh_degree)
