"""``jax.image.resize`` in PyTorch. Counterpart: every ``jax.image.resize``
call of ``tpugs/encoders`` (the LSeg crop and resize back, the DPT fusion
upsample, the positional-embedding interpolation, DINO's resize back).

jax resizes with half-pixel centres and, by default, an antialiased kernel
whose support widens by the scale when it shrinks. The PyTorch modes that
compute the same are not the obvious ones:

  jax "bilinear" = ``F.interpolate(mode="bilinear", antialias=True)``; without
  ``antialias`` a bilinear downsample differs by up to 0.5;
  jax "cubic" = ``mode="bicubic", antialias=True``: Keys' kernel with
  a = -0.5; PyTorch's plain bicubic uses a = -0.75;
  jax "nearest" = ``mode="nearest-exact"`` (half-pixel); PyTorch's
  "nearest" floors the source coordinate instead.

Where no axis shrinks, the antialiased bilinear kernel computes the plain
one's triangle filter, so ``resize`` takes PyTorch's plain bilinear kernel
there (faster on the card, and it keeps a channels-last layout); the cubic
kernels differ in ``a`` and stay antialiased.

Every resize of the port's encoders goes through ``resize``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_MODES = {
    "bilinear": dict(mode="bilinear", align_corners=False, antialias=True),
    "cubic": dict(mode="bicubic", align_corners=False, antialias=True),
    "nearest": dict(mode="nearest-exact"),
}


def resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """Resize the last two axes of an (N, C, H, W) tensor to ``size`` as
    ``jax.image.resize`` does with ``method`` ("bilinear", "cubic" or
    "nearest"). Reduced-precision input is resized in
    float32 and cast back; the memory format is kept where PyTorch's
    kernel keeps it."""
    if method not in _MODES:
        raise ValueError(f"unknown resize method {method!r}; expected one of {sorted(_MODES)}")
    if x.ndim != 4:
        raise ValueError(f"(N, C, H, W) expected, got {tuple(x.shape)}")
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    kw = _MODES[method]
    if kw["mode"] == "bilinear" and size[0] >= x.shape[-2] and size[1] >= x.shape[-1]:
        kw = dict(kw, antialias=False)
    dtype = x.dtype
    y = F.interpolate(x.float() if dtype != torch.float32 else x, size=size, **kw)
    return y.to(dtype)
