"""Gradient pruning and the render-equivalence check. Counterpart:
``tpugs/lift/prune.py:31-140``.

``prune_by_gradients`` keeps the Gaussians with a nonzero total blend
weight over every view's pixels: the colour gradient of a render is
sum_p w(g, p) dL/dI(p), so this is the reference's "nonzero gradient"
mask, computed by one adjoint pass per view (``accumulate_view`` without
features: B2 with one zero channel, then B3). ``verify_pruning_equivalence``
re-renders every view with both scenes and asserts that no pixel moves by
1/510 or more.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpugs_torch.core.camera import Camera
from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.lift.ops import accumulate_view
from tpugs_torch.raster.api import plan_render, rasterize_with_plan


def compute_visibility_weights(scene: GaussianScene, cams: Camera,
                               device: DeviceLike = "cuda") -> torch.Tensor:
    """(N,) total blend weight over every view's pixels, on ``device``."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    total = torch.zeros((scene.num_gaussians,), dtype=torch.float32, device=dev)
    for c in range(cams.num_cameras):
        _, wsum = accumulate_view(scene, cams.viewmats[c], cams.Ks[c], cams.width,
                                  cams.height, device=dev)
        total = total + wsum
    return total


def prune_by_gradients(scene: GaussianScene, cams: Camera, verbose: bool = True,
                       device: DeviceLike = "cuda") -> GaussianScene:
    """The scene without the Gaussians of zero blend weight in every view."""
    weights = compute_visibility_weights(scene, cams, device)
    mask = weights > 0
    if verbose:
        print("Total splats", len(weights))
        print("Pruned", int((~mask).sum()), "splats")
        print("Remaining", int(mask.sum()), "splats")
    return scene.to(weights.device).select(mask)


def render_view_sh(scene: GaussianScene, cams: Camera, c: int,
                   device: DeviceLike = "cuda"):
    """(image (H, W, 3), alpha (H, W)) of camera ``c`` at the scene's SH
    degree."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    vm, K = cams.viewmats[c].to(dev), cams.Ks[c].to(dev)
    with torch.no_grad():
        plan = plan_render(scene.means, scene.quats, scene.scales, scene.opacities, vm, K,
                           cams.width, cams.height)
        return rasterize_with_plan(scene.means, scene.quats, scene.scales, scene.opacities,
                                   scene.colors_all, vm, K, plan, sh_degree=scene.sh_degree)


def verify_pruning_equivalence(
    scene: GaussianScene,
    scene_pruned: GaussianScene,
    cams: Camera,
    verbose: bool = True,
    device: DeviceLike = "cuda",
) -> Tuple[float, float]:
    """Assert the pruned scene renders every view like the full one (max
    pixel error < 1/510, the reference's safety margin); returns (max pixel
    error, total pixel error)."""
    total_error = 0.0
    max_pixel_error = 0.0
    for c in range(cams.num_cameras):
        img_a, _ = render_view_sh(scene, cams, c, device)
        img_b, _ = render_view_sh(scene_pruned, cams, c, device)
        diff = (img_a - img_b).abs()
        total_error += float(diff.sum())
        max_pixel_error = max(max_pixel_error, float(diff.max()))

    percentage_pruned = (
        (scene.num_gaussians - scene_pruned.num_gaussians)
        / scene.num_gaussians
        * 100
    )
    assert max_pixel_error < 1 / (255 * 2), (
        "Max pixel error should be less than 1/(255*2), safety margin"
    )
    if verbose:
        print(
            "Report {}% pruned, max pixel error = {}, total pixel error = {}".format(
                percentage_pruned, max_pixel_error, total_error
            )
        )
    return max_pixel_error, total_error


# The reference's name (its utils.py:292); __test__ = False keeps pytest
# from collecting it.
test_proper_pruning = verify_pruning_equivalence
test_proper_pruning.__test__ = False
