"""Trainer auxiliary modules. Counterpart: ``tpugs/train/modules.py``.

* ``rotation_6d_to_matrix`` — the continuous 6D rotation parameterisation;
* ``CameraOptModule`` — per-camera 6D-rotation + translation deltas on
  camera-to-world poses, identity-initialised;
* ``AppearanceOptModule`` — per-image embedding + view-direction SH basis
  + per-Gaussian features -> MLP -> additive RGB. Its Dense layers are
  ``nn.Linear`` (weight = the Flax kernel transposed; ``convert.py::
  appearance_from_flax`` maps tpugs' params onto it), initialised as
  Flax's ``Dense`` is: truncated-normal LeCun weights, zero biases, from
  the caller's generator;
* ``apply_float_colormap`` / ``apply_depth_colormap`` — host-side
  colormaps: matplotlib's lookup on the port's own copy of its table
  (``train/colormaps.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.raster.sh import eval_sh_basis, num_sh_bases
from tpugs_torch.train.colormaps import COLORMAPS


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3), rows b1, b2, b3 (Zhou et al.)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / (torch.linalg.vector_norm(a1, dim=-1, keepdim=True) + 1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / (torch.linalg.vector_norm(b2, dim=-1, keepdim=True) + 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def pose_transform(d: torch.Tensor) -> torch.Tensor:
    """(..., 9) [6d rotation | translation] -> (..., 4, 4) rigid transform."""
    tf = torch.zeros(d.shape[:-1] + (4, 4), dtype=d.dtype, device=d.device)
    tf[..., :3, :3] = rotation_6d_to_matrix(d[..., :6])
    tf[..., :3, 3] = d[..., 6:]
    tf[..., 3, 3] = 1.0
    return tf


IDENTITY_POSE = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0)


class CameraOptModule(nn.Module):
    """Residual pose adjustment: ``pose_deltas`` (n_cameras, 9) start at
    the identity encoding with zero translation; ``forward(c2w (B, 4, 4),
    ids (B,))`` is ``c2w @ transform(deltas[ids])``."""

    def __init__(self, n_cameras: int, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.pose_deltas = nn.Parameter(
            torch.tensor(IDENTITY_POSE, device=dev).repeat(n_cameras, 1))

    def forward(self, camtoworlds: torch.Tensor, embed_ids: torch.Tensor) -> torch.Tensor:
        return camtoworlds @ pose_transform(self.pose_deltas[embed_ids])


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """Flax's default Dense kernel init: variance 1/fan_in, truncated at 2
    standard deviations of the untruncated normal."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class AppearanceOptModule(nn.Module):
    """``forward(features (N, Df), embed_ids (() int or None), dirs (N, 3))
    -> (N, 3)`` additive colour. ``embeds`` (n_images, embed_dim) start at
    zero; without ``embed_ids`` the embedding is zero."""

    def __init__(self, n_images: int, feature_dim: int = 32, embed_dim: int = 16,
                 sh_degree: int = 3, mlp_width: int = 64, mlp_depth: int = 2,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim, self.sh_degree = embed_dim, sh_degree
        self.embeds = nn.Parameter(torch.zeros((n_images, embed_dim), device=dev))
        widths = [embed_dim + feature_dim + num_sh_bases(sh_degree)] + [mlp_width] * mlp_depth
        self.hidden = nn.ModuleList(
            nn.Linear(a, b, device=dev) for a, b in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], 3, device=dev)
        with torch.no_grad():
            for lin in (*self.hidden, self.out):
                _lecun_normal_(lin.weight, lin.in_features, generator)
                lin.bias.zero_()

    def forward(self, features: torch.Tensor, embed_ids, dirs: torch.Tensor) -> torch.Tensor:
        n = features.shape[0]
        if embed_ids is None:
            embed = features.new_zeros((n, self.embed_dim))
        else:
            embed = self.embeds[embed_ids].expand(n, self.embed_dim)
        dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-12)
        basis = eval_sh_basis(self.sh_degree, dirs)[:, :num_sh_bases(self.sh_degree)]
        h = torch.cat([embed, features, basis], dim=-1)
        for lin in self.hidden:
            h = torch.relu(lin(h))
        return self.out(h)


def apply_float_colormap(img: np.ndarray, colormap: str = "turbo") -> np.ndarray:
    """[0, 1] float map -> uint8 RGB through one of the colormaps the port
    carries (``COLORMAPS``), with matplotlib's lookup: x clipped to [0, 1],
    row floor(x * 256) (in x's own precision; 1 takes the last row), NaN
    the "bad" colour (0, 0, 0); each channel * 255, truncated."""
    table = COLORMAPS.get(colormap)
    if table is None:
        raise ValueError(f"colormap {colormap!r} is not one the port carries "
                         f"({sorted(COLORMAPS)})")
    n = len(table)
    x = np.array(np.clip(img, 0, 1), copy=True)
    bad = np.isnan(x) if x.dtype.kind == "f" else np.zeros(x.shape, bool)
    if x.dtype.kind == "f":
        x *= n
        x[x == n] = n - 1
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    rgb = table[np.clip(idx, 0, n - 1)]
    rgb[bad] = 0.0
    return (rgb * 255).astype(np.uint8)


def apply_depth_colormap(depth: np.ndarray, acc: Optional[np.ndarray] = None,
                         near: Optional[float] = None,
                         far: Optional[float] = None) -> np.ndarray:
    near = float(np.nanmin(depth)) if near is None else near
    far = float(np.nanmax(depth)) if far is None else far
    img = apply_float_colormap((depth - near) / (far - near + 1e-10))
    if acc is not None:
        img = (img * acc[..., None]).astype(np.uint8)
    return img
