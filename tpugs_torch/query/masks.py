"""Scene editing by 3D masks. Counterpart: ``tpugs/query/masks.py:21-70``.

``apply_mask3d`` returns three edited scenes:
  * ``extracted`` — only the masked Gaussians;
  * ``deleted``   — only the unmasked Gaussians;
  * ``masked``    — all Gaussians, DC colour 1 on the mask and 0 elsewhere,
    higher-order SH zeroed outside it (white on black when rendered).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpugs_torch.core.scene import GaussianScene

C0 = 0.2820947917738781  # SH band-0 constant


def _bool_mask(scene: GaussianScene, mask3d) -> torch.Tensor:
    return torch.as_tensor(mask3d, device=scene.means.device).bool()


def apply_mask3d(
    scene: GaussianScene,
    mask3d,
    mask3d_inverted=None,
) -> Tuple[GaussianScene, GaussianScene, GaussianScene]:
    mask = _bool_mask(scene, mask3d)
    inv = _bool_mask(scene, mask3d_inverted) if mask3d_inverted is not None else ~mask
    extracted = scene.select(mask)
    deleted = scene.select(inv)
    sel = mask[:, None, None]
    sh0 = torch.where(sel, 1.0, 0.0) * torch.ones_like(scene.sh0)
    shN = torch.where(sel, scene.shN, 0.0)
    return extracted, deleted, scene.replace(sh0=sh0, shN=shN)


def segment_by_opacity(
    scene: GaussianScene, mask3d, hidden_logit: float = -30.0
) -> GaussianScene:
    """Soft deletion: opacity logit ``hidden_logit`` outside the mask (the
    viewer's path). Keeps N."""
    mask = _bool_mask(scene, mask3d)
    return scene.replace(logit_opacities=torch.where(
        mask, scene.logit_opacities, torch.full_like(scene.logit_opacities, hidden_logit)))


def recolor(
    scene: GaussianScene,
    mask3d,
    rgb: Tuple[float, float, float],
    strength: float = 1.0,
) -> GaussianScene:
    """Tint the masked Gaussians toward ``rgb``: grey the DC colour, then
    scale it by the target colour."""
    mask = _bool_mask(scene, mask3d)[:, None]
    colors = scene.sh0[:, 0, :] * C0 + 0.5
    gray = colors.mean(dim=-1, keepdim=True)
    target = gray * torch.tensor(rgb, dtype=torch.float32, device=colors.device)[None, :]
    new_colors = torch.where(mask, (1 - strength) * colors + strength * target, colors)
    return scene.replace(sh0=((new_colors - 0.5) / C0)[:, None, :])
