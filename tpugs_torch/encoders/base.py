"""Synthetic 2D feature encoders. Counterpart: ``tpugs/encoders/base.py:36-88``
(``GrayscaleEncoder``, ``LinearRGBEncoder``, ``PatchAverageEncoder``).

An encoder maps an ``(..., 3)`` rendering to ``(..., feature_dim)``
features. ``pixelwise = True`` marks encoders that map each pixel
independently: the fused back-projection then runs them on the render
kernel's tile layout ``(n_tiles, ts*ts, 3)`` and needs no image<->tile
transpose.
"""

from __future__ import annotations

import numpy as np
import torch

from tpugs_torch.core.device import DeviceLike, resolve_device


class GrayscaleEncoder:
    """1-d luminance features — the minimal end-to-end probe."""

    feature_dim = 1
    pixelwise = True

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype,
                         device=image.device)
        return (image @ w)[..., None]


class LinearRGBEncoder:
    """Fixed random linear map of RGB -> D features, L2-normalised per
    pixel. The ``(3, D)`` projection is drawn from
    ``np.random.default_rng(seed)`` exactly as the reference draws it."""

    pixelwise = True

    def __init__(
        self,
        feature_dim: int = 16,
        seed: int = 0,
        normalize: bool = True,
        device: DeviceLike = "cuda",
    ):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        proj = rng.normal(size=(3, feature_dim)).astype(np.float32)
        self.proj = torch.from_numpy(proj).to(dev)
        self.feature_dim = feature_dim
        self.normalize = normalize

    @classmethod
    def from_projection(
        cls, proj: torch.Tensor, normalize: bool = True
    ) -> "LinearRGBEncoder":
        enc = cls.__new__(cls)
        enc.proj = proj
        enc.feature_dim = proj.shape[1]
        enc.normalize = normalize
        return enc

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        f = image @ self.proj
        if self.normalize:
            f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-8)
        return f


class PatchAverageEncoder:
    """Averages over PxP patches then nearest-upsamples back, on an
    (H, W, 3) image (not pixelwise)."""

    def __init__(self, inner, patch: int = 8):
        self.inner = inner
        self.patch = patch
        self.feature_dim = inner.feature_dim

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        f = self.inner(image)
        H, W, D = f.shape
        P = self.patch
        hp, wp = H // P, W // P
        f = f[: hp * P, : wp * P]
        f = f.reshape(hp, P, wp, P, D).mean(dim=(1, 3))
        f = f.repeat_interleave(P, dim=0).repeat_interleave(P, dim=1)
        # edge padding back to (H, W)
        if H > hp * P:
            f = torch.cat([f, f[-1:].expand(H - hp * P, -1, -1)], dim=0)
        if W > wp * P:
            f = torch.cat([f, f[:, -1:].expand(-1, W - wp * P, -1)], dim=1)
        return f
