"""DINOv2 ViT-L/14-reg patch-feature encoder. Counterpart:
``tpugs/encoders/dino.py``.

Reference usage (``backproject.py:175-249``): resize the render to 896x896
(raw [0, 1]: no ImageNet normalisation before ``forward_features``),
``x_norm_patchtokens`` reshaped to (64, 64, 1024), a nearest resize back to
the image size. Kept for parity with tpugs: the nearest resize is
half-pixel (``nearest-exact``), and the positional embeddings interpolate
with ``DINOV2_VIT_L14_REG.pos_interp`` = "cubic", i.e. Keys' a = -0.5
with antialiasing, not DINOv2's own bicubic.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from tpugs_torch.core.device import DeviceLike
from tpugs_torch.encoders.resize import resize
from tpugs_torch.encoders.vit import DINOV2_VIT_L14_REG, VisionTransformer, init_flax_like_


class DinoEncoder:
    feature_dim = 1024
    pixelwise = False

    def __init__(self, ckpt=None, image_size: int = 896, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = "cuda"):
        vit = VisionTransformer(DINOV2_VIT_L14_REG, act="gelu", device=device)
        if ckpt:
            from tpugs_torch.encoders.convert import load_dino_state_dict

            vit.load_state_dict(load_dino_state_dict(ckpt))
        else:
            init_flax_like_(vit, seed=0)
            warnings.warn("DinoEncoder initialized with RANDOM weights (no checkpoint).")
        self._setup(vit, image_size, dtype)

    @classmethod
    def from_vit(cls, vit: VisionTransformer, image_size: int = 896,
                 dtype: Optional[torch.dtype] = None) -> "DinoEncoder":
        """The protocol around a backbone built by the caller (any size)."""
        enc = cls.__new__(cls)
        enc._setup(vit, image_size, dtype)
        return enc

    def _setup(self, vit: VisionTransformer, image_size: int,
               dtype: Optional[torch.dtype]) -> None:
        self.vit = vit.eval() if dtype is None else vit.to(dtype).eval()
        self.image_size = image_size
        self.dtype = dtype
        self.feature_dim = vit.cfg.width

    @torch.no_grad()
    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) -> (H, W, feature_dim) float32."""
        H, W, _ = image.shape
        s = self.image_size
        x = resize(image.permute(2, 0, 1)[None], (s, s), "bilinear")
        if self.dtype is not None:
            x = x.to(self.dtype)
        out = self.vit(x)
        gh, gw = out["grid"]
        tokens = out["final"][:, out["n_prefix"]:, :].float()
        feats = tokens.transpose(1, 2).reshape(1, self.feature_dim, gh, gw)
        # channels-last, so the resized features are (H, W, D) in memory
        feats = resize(feats.contiguous(memory_format=torch.channels_last), (H, W), "nearest")
        return feats[0].permute(1, 2, 0).contiguous()
