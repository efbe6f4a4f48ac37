"""The eager feature back-projection. Counterpart:
``tpugs/lift/backproject.py:38-135`` (``backproject_view``,
``create_feature_field``).

Per camera: the RGB render at the scene's SH degree through
``rasterize_with_plan`` (B4, no early exit), the 2D encoder on the
(H, W, 3) image, then one fused adjoint pass (``accumulate_view``: B2 and
B3) on the same plan; the sums accumulate over views and are divided,
L2-normalised and NaN-zeroed at the end.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from tpugs_torch.core.camera import Camera
from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.lift.ops import accumulate_view
from tpugs_torch.raster.api import plan_render, rasterize_with_plan
from tpugs_torch.raster.projection import ProjectionConfig

DENOM_INIT = 1e-12  # the denominators start at 1e-12, as the reference's do


def backproject_view(
    scene: GaussianScene,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    encoder: Callable[[torch.Tensor], torch.Tensor],
    proj_config: ProjectionConfig = ProjectionConfig(),
    device: DeviceLike = "cuda",
    record: Optional[dict] = None,
):
    """One camera: render, encode, fused adjoint. Returns (feat_sums (N, D),
    weight_sums (N,)) on ``device``; the plan is built once and shared.
    ``record``, a dict, receives the render's kernel inputs and outputs and
    the adjoint's (``render_plan_train``, ``backproject_tiled``)."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    viewmat, K = viewmat.to(dev), K.to(dev)
    with torch.no_grad():
        plan = plan_render(scene.means, scene.quats, scene.scales, scene.opacities, viewmat,
                           K, width, height, proj_config)
        rgb, _ = rasterize_with_plan(scene.means, scene.quats, scene.scales, scene.opacities,
                                     scene.colors_all, viewmat, K, plan,
                                     sh_degree=scene.sh_degree, proj_config=proj_config,
                                     record=record)
        feats = encoder(rgb)  # (H, W, D)
    return accumulate_view(scene, viewmat, K, width, height, feats, proj_config, plan, dev,
                           record)


def create_feature_field(
    scene: GaussianScene,
    cams: Camera,
    encoder: Callable[[torch.Tensor], torch.Tensor],
    feature_dim: Optional[int] = None,
    proj_config: ProjectionConfig = ProjectionConfig(),
    verbose: bool = True,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Back-project 2D features from every view onto the Gaussians: (N, D)
    L2-normalised features on ``device``, rows without weight zeroed."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    n = scene.num_gaussians
    if feature_dim is None:
        feature_dim = encoder.feature_dim
    num = torch.zeros((n, feature_dim), dtype=torch.float32, device=dev)
    den = torch.full((n,), DENOM_INIT, dtype=torch.float32, device=dev)
    t1 = time.time()
    for c in range(cams.num_cameras):
        feat_sums, weight_sums = backproject_view(scene, cams.viewmats[c], cams.Ks[c],
                                                  cams.width, cams.height, encoder,
                                                  proj_config, dev)
        num = num + feat_sums
        den = den + weight_sums
    features = num / den[:, None]
    features = features / torch.linalg.vector_norm(features, dim=-1, keepdim=True)
    features = torch.nan_to_num(features, nan=0.0, posinf=0.0, neginf=0.0)
    if verbose:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print("Time taken for feature backprojection", time.time() - t1)
    return features
