"""Encoder registry. Counterpart: ``tpugs/encoders/__init__.py::get_encoder``,
for the ``grayscale`` and ``linear[:D]`` specs; the ViT encoders wait for
ROADMAP item 2."""

from __future__ import annotations

from tpugs_torch.core.device import DeviceLike
from tpugs_torch.encoders.base import GrayscaleEncoder, LinearRGBEncoder


def get_encoder(name: str, device: DeviceLike = "cuda"):
    """grayscale | linear[:D] (D defaults to 16, seed 0 as in tpugs)."""
    if name == "grayscale":
        return GrayscaleEncoder()
    if name.startswith("linear"):
        dim = int(name.split(":")[1]) if ":" in name else 16
        return LinearRGBEncoder(feature_dim=dim, device=device)
    if name in ("lseg", "dino"):
        raise NotImplementedError(f"encoder {name!r} is not ported yet: ROADMAP item 2")
    raise ValueError(f"unknown encoder {name!r}")
