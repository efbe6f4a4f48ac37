"""Per-intersection parameter pack. Counterpart:
``tpugs/raster/pallas_tiled.py:1026-1080`` (``pack_isect_all``).

Row-major ``(T_padded, 16)`` float32, one 64-byte row per padded slot:
``[mx, my, conic_a, conic_b, conic_c, opacity, depth, 0 |
c0, c1, c2, depth, 0, 0, 0, 0]``. Opacity is zeroed for invalid Gaussians,
rows are permuted to depth order, and padding slots read a trailing
all-zero dummy row, so padded lanes have alpha 0 in every kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpugs_torch.raster.plan import Plan
from tpugs_torch.raster.projection import Projected

PACK_COLS = 16
COL_GEOM = 0  # mx, my, ca, cb, cc, op at 0..5
COL_COLOR = 8  # c0, c1, c2, depth at 8..11


def pack_isect_all(
    proj: Projected, colors3: Optional[torch.Tensor], plan: Plan
) -> torch.Tensor:
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    return pack_rows(proj.means2d, proj.conics, opac, proj.depths, colors3, plan)


def pack_rows(
    means2d: torch.Tensor,  # (N, 2) original order
    conics: torch.Tensor,  # (N, 3)
    opacities: torch.Tensor,  # (N,) validity-masked
    depths: Optional[torch.Tensor],  # (N,) or None for zeros
    colors3: Optional[torch.Tensor],  # (N, 3) or None for zeros
    plan: Plan,
) -> torch.Tensor:
    """``pack_isect_all`` of loose per-Gaussian tensors."""
    zeros = torch.zeros_like(opacities)
    if depths is None:
        depths = zeros
    if colors3 is None:
        c0 = c1 = c2 = zeros
    else:
        c0, c1, c2 = colors3[:, 0], colors3[:, 1], colors3[:, 2]
    packed = torch.stack(
        [
            means2d[:, 0],
            means2d[:, 1],
            conics[:, 0],
            conics[:, 1],
            conics[:, 2],
            opacities,
            depths,
            zeros,
            c0,
            c1,
            c2,
            depths,
            zeros,
            zeros,
            zeros,
            zeros,
        ],
        dim=1,
    )[plan.order]
    packed = torch.cat([packed, packed.new_zeros((1, PACK_COLS))], dim=0)
    return packed[plan.padded_gid.long()].contiguous()
