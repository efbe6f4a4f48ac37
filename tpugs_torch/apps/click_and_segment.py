"""Click-prompt 3D segmentation app. Counterpart:
``tpugs/apps/click_and_segment.py``.

The headless core, ``PromptSession``:

* render RGB+ED (depth over alpha) and the lifted (N, D) field as a
  feature image once per view (B4 at D = 4 and at the field's width);
  both stay on the scene's device, and a click brings only its pixel to
  the host, where the pixel's depth unprojects to a 3D anchor;
* the prompt's feature is the rendered feature at the click;
* mask3d = the best positive cosine above the best negative one
  (``query/text.py::get_mask3d``), on the device;
* markers re-project into any view with ``project_point``;
* three panes, original | extracted | deleted, the deletion by opacity
  (``query/masks.py::segment_by_opacity``).

``main`` is the cv2 loop (click: positive; shift-click: negative;
ctrl-click: remove the nearest marker; n: next view; q: quit)::

    python -m tpugs_torch.apps.click_and_segment --data-dir DATA \\
        --checkpoint CKPT --results-dir OUT --feature linear:8 [--device cpu]

It reads ``OUT/features_{feature}.npz`` as ``apps/backproject.py`` writes
it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene


def unproject_pixel(
    x: float, y: float, depth: float, viewmat: np.ndarray, K: np.ndarray
) -> np.ndarray:
    """Pixel + rendered depth -> world point."""
    K = np.asarray(K)
    d = np.array([(x - K[0, 2]) / K[0, 0], (y - K[1, 2]) / K[1, 1], 1.0]) * depth
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    return R.T @ (d - t)


def project_point(
    p_world: np.ndarray, viewmat: np.ndarray, K: np.ndarray
) -> Optional[Tuple[int, int]]:
    """World point -> pixel, or None behind the camera."""
    cam = viewmat[:3, :3] @ p_world + viewmat[:3, 3]
    if cam[2] <= 1e-6:
        return None
    uv = np.asarray(K) @ cam
    return int(round(uv[0] / uv[2])), int(round(uv[1] / uv[2]))


@dataclasses.dataclass
class Prompt:
    anchor: np.ndarray  # (3,) world-space
    feature: np.ndarray  # (D,)
    positive: bool


class PromptSession:
    """Click-prompt state and mask computation on ``device``."""

    def __init__(
        self,
        scene: GaussianScene,
        features,  # (N, D) lifted field
        other_feature: Optional[np.ndarray] = None,  # a fixed negative, e.g. CLIP "other"
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.features = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        self.prompts: List[Prompt] = []
        self.other_feature = other_feature

    def _plan(self, scene: GaussianScene, viewmat, K, width, height):
        """(viewmat, K, plan) of one view on the session's device."""
        from tpugs_torch.raster.api import plan_render

        vm = torch.as_tensor(np.array(viewmat, dtype=np.float32), device=self.device)
        Kt = torch.as_tensor(np.array(K, dtype=np.float32), device=self.device)
        plan = plan_render(scene.means, scene.quats, scene.scales, scene.opacities, vm, Kt,
                           width, height)
        return vm, Kt, plan

    def render_rgbd_features(self, viewmat, K, width, height):
        """(RGB+ED image (H, W, 4), feature image (H, W, D)) of one view on
        the session's device: the lookup source of clicks."""
        from tpugs_torch.raster.api import rasterize_with_plan

        s = self.scene
        with torch.no_grad():
            vm, Kt, plan = self._plan(s, viewmat, K, width, height)
            rgbd, _ = rasterize_with_plan(s.means, s.quats, s.scales, s.opacities,
                                          s.colors_all, vm, Kt, plan, sh_degree=s.sh_degree,
                                          render_mode="RGB+ED")
            feat_img, _ = rasterize_with_plan(s.means, s.quats, s.scales, s.opacities,
                                              self.features, vm, Kt, plan)
        return rgbd, feat_img

    def add_click(
        self, x: int, y: int, rgbd, feat_img, viewmat, K, positive: bool = True,
    ) -> Prompt:
        depth = float(rgbd[y, x, 3])
        anchor = unproject_pixel(x, y, depth, np.asarray(viewmat), K)
        feature = torch.as_tensor(feat_img[y, x]).cpu().numpy()
        p = Prompt(anchor=anchor, feature=feature, positive=positive)
        self.prompts.append(p)
        return p

    def remove_nearest(self, x: int, y: int, viewmat, K, max_px: float = 30.0):
        """Remove the marker nearest (x, y) within ``max_px``; returns its
        index or None."""
        best, best_d = None, max_px
        for i, p in enumerate(self.prompts):
            uv = project_point(p.anchor, np.asarray(viewmat), K)
            if uv is None:
                continue
            d = float(np.hypot(uv[0] - x, uv[1] - y))
            if d < best_d:
                best, best_d = i, d
        if best is not None:
            self.prompts.pop(best)
        return best

    def mask3d(self) -> Optional[torch.Tensor]:
        """(N,) bool mask on the session's device, or None without a
        positive and a negative prompt."""
        pos = [p.feature for p in self.prompts if p.positive]
        neg = [p.feature for p in self.prompts if not p.positive]
        if self.other_feature is not None:
            neg = neg + [self.other_feature]
        if not pos or not neg:
            return None
        from tpugs_torch.query.text import get_mask3d

        mask, _ = get_mask3d(self.features,
                             torch.from_numpy(np.stack(pos).astype(np.float32)),
                             torch.from_numpy(np.stack(neg).astype(np.float32)))
        return mask

    def three_pane(self, viewmat, K, width, height) -> np.ndarray:
        """original | extracted | deleted, (H, 3W, 3) uint8 on the host,
        with the prompts' markers on the first pane."""
        from tpugs_torch.query.masks import segment_by_opacity
        from tpugs_torch.raster.api import rasterize_with_plan
        from tpugs_torch.viz.common import uint8_image

        mask = self.mask3d()

        def render(scene):
            with torch.no_grad():
                vm, Kt, plan = self._plan(scene, viewmat, K, width, height)
                img, _ = rasterize_with_plan(scene.means, scene.quats, scene.scales,
                                             scene.opacities, scene.colors_all, vm, Kt, plan,
                                             sh_degree=scene.sh_degree)
            return uint8_image(img)

        original = render(self.scene)
        if mask is None:
            extracted = torch.zeros_like(original)
            deleted = original
        else:
            extracted = render(segment_by_opacity(self.scene, mask))
            deleted = render(segment_by_opacity(self.scene, ~mask))
        frame = torch.cat([original, extracted, deleted], dim=1).cpu().numpy()
        for p in self.prompts:
            uv = project_point(p.anchor, np.asarray(viewmat), K)
            if uv is None:
                continue
            u, v = uv
            if 0 <= u < width and 0 <= v < height:
                color = np.array([0, 255, 0]) if p.positive else np.array([255, 0, 0])
                frame[max(v - 2, 0): v + 3, max(u - 2, 0): u + 3] = color
        return frame


def main(
    data_dir: str = "./data/garden",
    checkpoint: str = "./data/garden/ckpts/ckpt_29999_rank0.pt",
    results_dir: str = "./results/garden",
    format: str = "gsplat",
    data_factor: int = 4,
    feature: str = "lseg",
    skip_prune: bool = False,
    device: str = "cuda",
):  # pragma: no cover - interactive
    import os

    import cv2

    from tpugs_torch.io.checkpoints import load_checkpoint
    from tpugs_torch.lift.prune import prune_by_gradients

    dev = resolve_device(device)
    scene, cams, _ = load_checkpoint(checkpoint, data_dir, format, data_factor, dev)
    if not skip_prune:
        scene = prune_by_gradients(scene, cams, device=dev)
    feats = np.load(os.path.join(results_dir, f"features_{feature}.npz"))["features"]
    session = PromptSession(scene, feats, device=dev)

    idx = 0
    vm = cams.viewmats[idx].cpu().numpy()
    K = cams.Ks[idx].cpu().numpy()
    rgbd, feat_img = session.render_rgbd_features(vm, K, cams.width, cams.height)

    def on_mouse(event, x, y, flags, param):
        if x >= cams.width:
            return
        if event == cv2.EVENT_LBUTTONDOWN:
            if flags & cv2.EVENT_FLAG_CTRLKEY:
                session.remove_nearest(x, y, vm, K)
            else:
                session.add_click(x, y, rgbd, feat_img, vm, K,
                                  positive=not (flags & cv2.EVENT_FLAG_SHIFTKEY))

    win = "click-and-segment"
    cv2.namedWindow(win, cv2.WINDOW_NORMAL)
    cv2.setMouseCallback(win, on_mouse)
    while True:
        frame = session.three_pane(vm, K, cams.width, cams.height)
        cv2.imshow(win, frame[..., ::-1])
        key = cv2.waitKey(50) & 0xFF
        if key in (ord("q"), 27):
            break
        if key == ord("n"):
            idx = (idx + 1) % cams.num_cameras
            vm = cams.viewmats[idx].cpu().numpy()
            K = cams.Ks[idx].cpu().numpy()
            rgbd, feat_img = session.render_rgbd_features(vm, K, cams.width, cams.height)
    cv2.destroyAllWindows()


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
