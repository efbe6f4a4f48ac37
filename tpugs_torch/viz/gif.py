"""GIF render pipelines. Counterpart: ``tpugs/viz/gif.py:25-120``.

``render_to_gif``         — every camera's render as a uint8 frame, with an
                            optional checkerboard composited through the
                            rendered alpha; a 10 fps GIF and per-frame PNGs.
``render_mask_2d_to_gif`` — per view, the RGB render and the D-channel
                            feature image, each pixel scored against the
                            queries and the mask overlaid in red.

Renders, masks and overlays run on the scene's device under
``torch.inference_mode()`` (``rasterize_with_plan``: B4 at the colours'
width); frames come back as host uint8 arrays. Files are written by
``io/images.py``: the GIF by the port's own encoder (``write_gif``), the
per-frame PNGs by ``cv2`` (``write_png``), where a path is given.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpugs_torch.core.camera import Camera
from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.io.images import write_gif, write_png
from tpugs_torch.query.text import get_mask2d
from tpugs_torch.raster.api import RasterPlan, plan_render, rasterize_with_plan
from tpugs_torch.viz.common import create_checkerboard, to_uint8, uint8_image


def view_plan(scene: GaussianScene, cams: Camera, c: int) -> RasterPlan:
    return plan_render(scene.means, scene.quats, scene.scales, scene.opacities,
                       cams.viewmats[c], cams.Ks[c], cams.width, cams.height)


def render_colors(scene: GaussianScene, cams: Camera, c: int, plan: RasterPlan, colors=None):
    """(image, alpha) of camera ``c`` on ``plan``: the scene's SH at its
    degree where ``colors`` is None, else ``colors`` (N, D) as they are."""
    if colors is None:
        colors, deg = scene.colors_all, scene.sh_degree
    else:
        deg = None
    return rasterize_with_plan(scene.means, scene.quats, scene.scales, scene.opacities,
                               colors, cams.viewmats[c], cams.Ks[c], plan, sh_degree=deg)


def save_gif(frames, output_path: str, fps: int = 10) -> None:
    write_gif(output_path, frames, duration_ms=1000.0 / fps, loop=0)


@torch.inference_mode()
def render_to_gif(
    output_path: Optional[str],
    scene: GaussianScene,
    cams: Camera,
    use_checkerboard_background: bool = False,
    no_sh: bool = False,
    save_frames: bool = True,
    fps: int = 10,
):
    """The list of uint8 frames; with ``output_path``, the GIF there and
    (``save_frames``) each frame as ``<output>.images/frame_XXXX.png``."""
    aux_dir = None
    if output_path is not None and save_frames:
        aux_dir = output_path + ".images"
        os.makedirs(aux_dir, exist_ok=True)
    colors = scene.sh0[:, 0, :] if no_sh else None
    board = None
    if use_checkerboard_background:
        board = torch.from_numpy(create_checkerboard(cams.width, cams.height)).to(
            scene.means.device)
    frames = []
    for c in range(cams.num_cameras):
        img, alpha = render_colors(scene, cams, c, view_plan(scene, cams, c), colors)
        if board is None:
            frame = to_uint8(img)
        else:
            a = alpha[..., None]
            frame = (uint8_image(img) * a + board * (1 - a)).clamp(0, 255).to(
                torch.uint8).cpu().numpy()
        frames.append(frame)
        if aux_dir is not None:
            write_png(f"{aux_dir}/frame_{c:04d}.png", frame)
    if output_path is not None:
        save_gif(frames, output_path, fps)
    return frames


def overlay_mask_red(frame, mask2d) -> np.ndarray:
    """Masked pixels become 0.75 image + 0.25 pure red; the rest pass
    through unchanged. ``frame`` (H, W, 3) uint8 and ``mask2d`` (H, W),
    tensors or arrays: float64 on the frame's device (tpugs' arithmetic),
    a host uint8 frame out."""
    f = torch.as_tensor(frame).double()
    m = torch.as_tensor(mask2d, device=f.device).double()[..., None]
    red = torch.tensor([255.0, 0.0, 0.0], dtype=torch.float64, device=f.device)
    out = (1 - m) * f + m * (0.75 * f + 0.25 * red)
    return out.clamp(0, 255).to(torch.uint8).cpu().numpy()


@torch.inference_mode()
def render_mask_2d_to_gif(
    scene: GaussianScene,
    features: torch.Tensor,  # (N, D) lifted features
    pos_queries: torch.Tensor,
    neg_queries: torch.Tensor,
    cams: Camera,
    output_path: Optional[str],
    fps: int = 10,
):
    """Per view: the RGB render with the mask of its rendered feature image
    (scored per pixel against the queries) overlaid in red. Returns the
    uint8 frames; writes the GIF where ``output_path`` is given."""
    frames = []
    for c in range(cams.num_cameras):
        plan = view_plan(scene, cams, c)
        img, _ = render_colors(scene, cams, c, plan)
        feat_img, _ = render_colors(scene, cams, c, plan, features)
        mask2d = get_mask2d(feat_img, pos_queries, neg_queries)
        frames.append(overlay_mask_red(uint8_image(img), mask2d))
    if output_path is not None:
        save_gif(frames, output_path, fps)
    return frames
