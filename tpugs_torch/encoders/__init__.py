"""Encoder registry. Counterpart: ``tpugs/encoders/__init__.py::get_encoder``."""

from __future__ import annotations

from typing import Optional

import torch

from tpugs_torch.core.device import DeviceLike
from tpugs_torch.encoders.base import GrayscaleEncoder, LinearRGBEncoder


def get_encoder(name: str, ckpt: Optional[str] = None, device: DeviceLike = "cuda",
                dtype: Optional[torch.dtype] = None):
    """grayscale | linear[:D] (D defaults to 16, seed 0 as in tpugs) | lseg |
    dino. ``ckpt`` is the ViT encoders' checkpoint (random weights without
    one); ``dtype`` their network's dtype (None: float32)."""
    if name == "grayscale":
        return GrayscaleEncoder()
    if name.startswith("linear"):
        dim = int(name.split(":")[1]) if ":" in name else 16
        return LinearRGBEncoder(feature_dim=dim, device=device)
    if name == "lseg":
        from tpugs_torch.encoders.lseg import LSegEncoder

        return LSegEncoder(ckpt, dtype=dtype, device=device)
    if name == "dino":
        from tpugs_torch.encoders.dino import DinoEncoder

        return DinoEncoder(ckpt, dtype=dtype, device=device)
    raise ValueError(f"unknown encoder {name!r}")
