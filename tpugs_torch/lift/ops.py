"""Adjoint ops on (scene, camera) pairs. Counterpart: ``tpugs/lift/ops.py``
(``accumulate_view`` :69-121): projection, then the fused weight and
feature accumulation of ``raster/adjoint.py`` (B2 and B3), with results in
original Gaussian order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.raster.adjoint import backproject_tiled
from tpugs_torch.raster.api import RasterPlan, plan_render
from tpugs_torch.raster.projection import ProjectionConfig, project


def accumulate_view(
    scene: GaussianScene,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    feat_image: Optional[torch.Tensor] = None,  # (H, W, D)
    proj_config: ProjectionConfig = ProjectionConfig(),
    plan: Optional[RasterPlan] = None,
    device: DeviceLike = "cuda",
    record: Optional[dict] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One view's fused adjoint pass on ``device``: (sum_p w(g, p) F(p) or
    None, sum_p w(g, p)) per Gaussian, in original order. ``plan``
    defaults to ``plan_render``'s; its projection is reused where it holds
    one. ``record`` as in ``backproject_tiled``."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    viewmat, K = viewmat.to(dev), K.to(dev)
    with torch.no_grad():
        if plan is None:
            plan = plan_render(scene.means, scene.quats, scene.scales, scene.opacities,
                               viewmat, K, width, height, proj_config)
        proj = plan.proj
        if proj is None:
            proj = project(scene.means, scene.quats, scene.scales, scene.opacities, viewmat, K,
                           plan.width, plan.height, proj_config)
        opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
        feats = None if feat_image is None else feat_image.to(dev)
        return backproject_tiled(proj.means2d, proj.conics, opac, feats, plan.plan, record)
