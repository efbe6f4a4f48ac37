"""Interactive OpenCV scene viewer. Counterpart: ``tpugs/apps/viewer.py``.

RPY/XYZ/scale trackbars, WASD dolly, canonical top/front/right views from
an estimated scene world-frame, a turntable mouse orbit, anaglyph stereo
(a second render with an eye offset, channel-masked merge) and an axes
overlay. The view-state math is numpy (``ViewerState``, headless); the
frame renders on the scene's device and only the uint8 frame comes to
the host; the cv2 event loop (``Viewer.run``) is a thin shell around
them. On the command line::

    python -m tpugs_torch.apps.viewer --data-dir DATA --checkpoint CKPT \\
        [--data-factor 1] [--anaglyph] [--skip-prune] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from tpugs_torch.core.camera import rpy_matrix
from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene


def estimate_scene_frame(viewmats: np.ndarray) -> np.ndarray:
    """World-frame guess from averaged camera poses: the mean camera
    "down" becomes +y, the mean forward made orthogonal to it +z."""
    R = viewmats[:, :3, :3]  # world-to-cam
    down = R[:, 1, :].mean(axis=0)  # camera +y rows in world coords
    down /= np.linalg.norm(down) + 1e-12
    fwd = R[:, 2, :].mean(axis=0)
    fwd = fwd - down * (fwd @ down)
    if np.linalg.norm(fwd) < 1e-6:
        # symmetric orbit: the mean forward is parallel to the mean down;
        # take the first camera's forward, then any perpendicular
        fwd = R[0, 2, :] - down * (R[0, 2, :] @ down)
    if np.linalg.norm(fwd) < 1e-6:
        ref = np.array([1.0, 0.0, 0.0])
        if abs(down @ ref) > 0.9:
            ref = np.array([0.0, 0.0, 1.0])
        fwd = ref - down * (ref @ down)
    fwd /= np.linalg.norm(fwd) + 1e-12
    right = np.cross(down, fwd)
    return np.stack([right, down, fwd], axis=0)  # rows: world axes


@dataclasses.dataclass
class ViewerState:
    """Trackbar-style view state -> 4x4 viewmat."""

    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    scale: float = 1.0
    base: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))

    def viewmat(self) -> np.ndarray:
        m = rpy_matrix(self.roll, self.pitch, self.yaw)
        m[:3, 3] = [self.x, self.y, self.z]
        out = m @ self.base
        out[:3, :] *= self.scale  # uniform scene scale
        out[3, 3] = 1.0
        return out.astype(np.float32)

    def set_canonical(self, which: str, frame: np.ndarray, dist: float = 3.0):
        base = np.eye(4)
        if which == "front":
            R = frame
        elif which == "top":
            R = np.stack([frame[0], frame[2], -frame[1]])
        elif which == "right":
            R = np.stack([-frame[2], frame[1], frame[0]])
        else:
            raise ValueError(which)
        base[:3, :3] = R
        base[:3, 3] = [0, 0, dist]
        self.base = base
        self.roll = self.pitch = self.yaw = 0.0
        self.x = self.y = self.z = 0.0

    def dolly(self, key: str, step: float = 0.1):
        if key == "w":
            self.z -= step
        elif key == "s":
            self.z += step
        elif key == "a":
            self.x += step
        elif key == "d":
            self.x -= step

    def orbit(self, dx_pixels: float, dy_pixels: float, pivot_depth: float = 3.0):
        """Rotate about the point ``pivot_depth`` in front of the camera."""
        yaw_delta = dx_pixels * 0.01
        pitch_delta = dy_pixels * 0.01
        vm = self.viewmat()
        pivot_cam = np.array([0, 0, pivot_depth, 1.0])
        rot = rpy_matrix(pitch_delta, yaw_delta, 0.0)
        t = np.eye(4)
        t[:3, 3] = -pivot_cam[:3]
        t_inv = np.eye(4)
        t_inv[:3, 3] = pivot_cam[:3]
        new_vm = t_inv @ rot @ t @ vm
        self.base = new_vm
        self.roll = self.pitch = self.yaw = 0.0
        self.x = self.y = self.z = 0.0
        self.scale = 1.0


def render_frame(
    scene: GaussianScene,
    viewmat: np.ndarray,
    K: np.ndarray,
    width: int,
    height: int,
    anaglyph: bool = False,
    eye_offset: float = 0.05,
    axes_overlay: bool = False,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """One viewer frame as (H, W, 3) uint8 RGB on the host, rendered on
    ``device`` through ``raster/train.py::render_scene`` (B4 with early
    exit, tile 16; the reference's "pallas" engine, ``render_scene_pallas``),
    optionally anaglyph stereo and the axes overlay."""
    from tpugs_torch.raster.train import render_scene
    from tpugs_torch.viz.common import to_uint8

    dev = resolve_device(device)
    scene = scene.to(dev)
    Kt = torch.as_tensor(np.array(K, dtype=np.float32), device=dev)

    def render(vm):
        vm = torch.as_tensor(np.array(vm, dtype=np.float32), device=dev)
        img, _ = render_scene(scene, vm, Kt, width, height)
        return to_uint8(img)

    frame = render(viewmat)
    if anaglyph:
        vm2 = np.array(viewmat, copy=True)
        vm2[0, 3] += eye_offset
        right = render(vm2)
        # red from the left eye, green and blue from the right
        frame = np.stack([frame[..., 0], right[..., 1], right[..., 2]], axis=-1)
    if axes_overlay:
        frame = draw_axes(frame, viewmat, K)
    return frame


def draw_axes(frame: np.ndarray, viewmat: np.ndarray, K: np.ndarray):
    """Project the world axes at the origin into the frame."""
    import cv2

    frame = np.ascontiguousarray(frame)
    pts = np.array([[0, 0, 0], [0.3, 0, 0], [0, 0.3, 0], [0, 0, 0.3]], np.float64)
    cam = pts @ viewmat[:3, :3].T + viewmat[:3, 3]
    if np.any(cam[:, 2] <= 0.01):
        return frame
    uv = cam @ np.asarray(K).T
    uv = (uv[:, :2] / uv[:, 2:3]).astype(int)
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]
    for i, c in enumerate(colors):
        cv2.line(frame, tuple(uv[0]), tuple(uv[i + 1]), c, 2)
    return frame


class Viewer:
    """The viewer's state and its cv2 event loop (``run``)."""

    def __init__(
        self,
        scene: GaussianScene,
        K,
        width: int,
        height: int,
        viewmats: Optional[np.ndarray] = None,
        anaglyph: bool = False,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.K = np.asarray(K)
        self.width, self.height = width, height
        self.anaglyph = anaglyph
        self.state = ViewerState()
        if viewmats is not None and len(viewmats):
            self.frame = estimate_scene_frame(np.asarray(viewmats))
            self.state.base = np.asarray(viewmats[0]).copy()
        else:
            self.frame = np.eye(3)
        self._drag_start = None

    def handle_key(self, key: str) -> bool:
        """Returns False when the viewer should exit."""
        if key in "wasd":
            self.state.dolly(key)
        elif key == "1":
            self.state.set_canonical("top", self.frame)
        elif key == "2":
            self.state.set_canonical("front", self.frame)
        elif key == "3":
            self.state.set_canonical("right", self.frame)
        elif key == "g":
            self.anaglyph = not self.anaglyph
        elif key in ("q", "\x1b"):
            return False
        return True

    def handle_mouse(self, event: str, x: int, y: int):
        if event == "down":
            self._drag_start = (x, y)
        elif event == "move" and self._drag_start is not None:
            dx = x - self._drag_start[0]
            dy = y - self._drag_start[1]
            self.state.orbit(dx, dy)
            self._drag_start = (x, y)
        elif event == "up":
            self._drag_start = None

    def render(self) -> np.ndarray:
        return render_frame(self.scene, self.state.viewmat(), self.K, self.width, self.height,
                            anaglyph=self.anaglyph, device=self.device)

    def run(self):  # pragma: no cover - needs a display
        import cv2

        win = "tpugs_torch viewer"
        cv2.namedWindow(win, cv2.WINDOW_NORMAL)
        for name, lo, hi, init in [
            ("roll", -180, 180, 0), ("pitch", -180, 180, 0),
            ("yaw", -180, 180, 0), ("x", -100, 100, 0),
            ("y", -100, 100, 0), ("z", -100, 100, 0),
            ("scale", 1, 200, 100),
        ]:
            cv2.createTrackbar(name, win, init - lo, hi - lo, lambda v: None)

        def mouse_cb(event, x, y, flags, param):
            if event == cv2.EVENT_LBUTTONDOWN:
                self.handle_mouse("down", x, y)
            elif event == cv2.EVENT_MOUSEMOVE:
                self.handle_mouse("move", x, y)
            elif event == cv2.EVENT_LBUTTONUP:
                self.handle_mouse("up", x, y)

        cv2.setMouseCallback(win, mouse_cb)
        while True:
            s = self.state
            s.roll = math.radians(cv2.getTrackbarPos("roll", win) - 180)
            s.pitch = math.radians(cv2.getTrackbarPos("pitch", win) - 180)
            s.yaw = math.radians(cv2.getTrackbarPos("yaw", win) - 180)
            s.x = (cv2.getTrackbarPos("x", win) - 100) / 10
            s.y = (cv2.getTrackbarPos("y", win) - 100) / 10
            s.z = (cv2.getTrackbarPos("z", win) - 100) / 10
            s.scale = cv2.getTrackbarPos("scale", win) / 100
            frame = self.render()
            cv2.imshow(win, frame[..., ::-1])
            key = cv2.waitKeyEx(30)
            if key >= 0 and not self.handle_key(chr(key & 0xFF)):
                break
        cv2.destroyAllWindows()


def main(
    data_dir: str = "./data/garden",
    checkpoint: str = "./data/garden/ckpts/ckpt_29999_rank0.pt",
    format: str = "gsplat",
    data_factor: int = 4,
    anaglyph: bool = False,
    skip_prune: bool = False,
    device: str = "cuda",
):  # pragma: no cover - needs a display
    from tpugs_torch.io.checkpoints import load_checkpoint
    from tpugs_torch.lift.prune import prune_by_gradients

    dev = resolve_device(device)
    scene, cams, _ = load_checkpoint(checkpoint, data_dir, format, data_factor, dev)
    if not skip_prune:
        scene = prune_by_gradients(scene, cams, device=dev)
    viewer = Viewer(scene, cams.Ks[0].cpu().numpy(), cams.width, cams.height,
                    viewmats=cams.viewmats.cpu().numpy(), anaglyph=anaglyph, device=dev)
    viewer.run()


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
