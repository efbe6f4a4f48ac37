"""Pinhole camera batches. Counterpart: ``tpugs/core/camera.py:26-90``
(``Camera``, ``make_viewmat``, ``intrinsics_matrix``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], dtype=np.float32)
