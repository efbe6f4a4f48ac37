"""Pinhole camera batches and pose math. Counterpart:
``tpugs/core/camera.py:26-112`` (``Camera`` with ``cam_centers`` and
``__getitem__``, ``make_viewmat``, ``rpy_matrix``, ``intrinsics_matrix``,
``cameras_from_colmap``)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tpugs_torch.core.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """A batch of pinhole cameras: ``viewmats`` (C, 4, 4) world-to-camera,
    ``Ks`` (C, 3, 3) intrinsics, and the image size in pixels."""

    viewmats: torch.Tensor
    Ks: torch.Tensor
    width: int
    height: int

    @property
    def num_cameras(self) -> int:
        return self.viewmats.shape[0]

    @property
    def cam_centers(self) -> torch.Tensor:
        """(C, 3) camera centres in the world frame: -R^T t."""
        R = self.viewmats[:, :3, :3]
        t = self.viewmats[:, :3, 3]
        return -torch.einsum("cij,ci->cj", R, t)

    def __getitem__(self, idx) -> "Camera":
        vm = self.viewmats[idx]
        K = self.Ks[idx]
        if vm.ndim == 2:
            vm, K = vm[None], K[None]
        return Camera(vm, K, self.width, self.height)

    def to(self, device) -> "Camera":
        return Camera(
            self.viewmats.to(device), self.Ks.to(device), self.width, self.height
        )


def make_viewmat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 world-to-camera from rotation (3, 3) and translation (3,)."""
    vm = torch.eye(4, dtype=torch.float32, device=R.device)
    vm[:3, :3] = R.to(torch.float32)
    vm[:3, 3] = t.to(torch.float32)
    return vm


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Yaw @ pitch @ roll 4x4, float64 numpy (the interactive viewer's)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    roll_m = np.array([[1, 0, 0, 0], [0, cr, -sr, 0], [0, sr, cr, 0], [0, 0, 0, 1.0]])
    pitch_m = np.array([[cp, 0, sp, 0], [0, 1, 0, 0], [-sp, 0, cp, 0], [0, 0, 0, 1.0]])
    yaw_m = np.array([[cy, -sy, 0, 0], [sy, cy, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    return yaw_m @ pitch_m @ roll_m


def intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], dtype=np.float32)


def cameras_from_colmap(
    images: Sequence, K: np.ndarray, width: int, height: int, device: DeviceLike = "cuda"
) -> Camera:
    """Stack COLMAP images (objects with ``.R()`` and ``.t``), in the order
    given, into a Camera batch on ``device``, every camera with ``K``. The
    matrices are built in numpy and moved once."""
    dev = resolve_device(device)

    def vm(im):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = im.R()
        m[:3, 3] = im.t
        return m

    viewmats = np.stack([vm(im) for im in images], axis=0)
    Ks = np.tile(np.asarray(K, np.float32)[None], (len(images), 1, 1))
    return Camera(torch.from_numpy(viewmats).to(dev), torch.from_numpy(Ks).to(dev),
                  int(width), int(height))
