"""LSeg pixel-feature encoder (CLIP-aligned 512-d per-pixel features).
Counterpart: ``tpugs/encoders/lseg.py``.

The network is lang-seg's LSegNet: a timm ViT-L/16 backbone
(``pretrained.model``), the DPT "project" readout and resample
(``pretrained.act_postprocess{1..4}``), the reassembly convs, the
residual fusion blocks and the head (``scratch.layer{1..4}_rn``,
``scratch.refinenet{1..4}``, ``scratch.head1``). Module names follow that
layout, so a lang-seg checkpoint loads through
``encoders/convert.py::load_lseg_state_dict``. Tensors are NCHW.

Kept for parity with tpugs: the fusion blocks' 2x upsample is half-pixel
bilinear (``resize``), where lang-seg's own block uses
``align_corners=True``; the last fusion block (``refinenet4``) has no
``resConfUnit1``, which DPT never applies.

``LSegEncoder`` is the protocol around it (reference
``backproject.py:102-113``): resize the render to the 480 crop, the
network, the per-pixel L2 norm, and resize back to the render's size.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.encoders.resize import resize
from tpugs_torch.encoders.vit import VisionTransformer, ViTConfig, init_flax_like_

HOOK_LAYERS = (5, 11, 17, 23)  # lseg clip_vitl16_384 hooks

# timm vit_large_patch16_384: biased patch embed, GELU blocks, eps 1e-6
TIMM_VIT_L16_384 = ViTConfig(
    image_size=480, patch_size=16, width=1024, layers=24, heads=16,
    pre_norm=False, layer_norm_eps=1e-6,
)


class ProjectReadout(nn.Module):
    """DPT's "project" readout: the class token concatenated onto every
    patch token, then Linear(2C -> C) and GELU (``.project``)."""

    def __init__(self, width: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * width, width), nn.GELU())

    def forward(self, tokens, cls):
        return self.project(torch.cat([tokens, cls[:, None, :].expand_as(tokens)], dim=-1))


def make_postprocess(width: int, channels: int, level: int) -> nn.Sequential:
    """``act_postprocess{level+1}``: readout (0), lang-seg's Transpose and
    Unflatten (1, 2: no parameters), a 1x1 conv to ``channels`` (3), and
    the resample (4): ConvTranspose x4, x2, none, a stride-2 3x3 conv."""
    mods = [ProjectReadout(width), nn.Identity(), nn.Identity(),
            nn.Conv2d(width, channels, 1)]
    if level == 0:
        mods.append(nn.ConvTranspose2d(channels, channels, 4, stride=4))
    elif level == 1:
        mods.append(nn.ConvTranspose2d(channels, channels, 2, stride=2))
    elif level == 3:
        mods.append(nn.Conv2d(channels, channels, 3, stride=2, padding=1))
    return nn.Sequential(*mods)


class ResidualConvUnit(nn.Module):
    """DPT ResidualConvUnit_custom (bn=False): x + conv(relu(conv(relu(x))))."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    """DPT FeatureFusionBlock_custom: skip-add through ``resConfUnit1``,
    ``resConfUnit2``, a 2x half-pixel bilinear upsample, 1x1 ``out_conv``."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize(x, (2 * x.shape[-2], 2 * x.shape[-1]), "bilinear")
        return self.out_conv(x)


class Scratch(nn.Module):
    def __init__(self, features: int, out_dim: int, layer_channels: Sequence[int]):
        super().__init__()
        for i, ch in enumerate(layer_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(ch, features, 3, padding=1, bias=False))
        for r in range(1, 5):
            setattr(self, f"refinenet{r}", FeatureFusion(features, with_skip=r != 4))
        self.head1 = nn.Conv2d(features, out_dim, 1)


def dpt_head(owner: nn.Module, scratch: Scratch, levels: Sequence[torch.Tensor],
             cls_tokens: Sequence[torch.Tensor], grid: Tuple[int, int]) -> torch.Tensor:
    """The readout, reassembly and fusion of four token levels (B, gh*gw, C)
    with their class tokens (B, C); ``owner`` holds ``act_postprocess{1..4}``.
    Returns (B, out_dim, 8 gh, 8 gw)."""
    gh, gw = grid
    reassembled = []
    for i, (tokens, cls) in enumerate(zip(levels, cls_tokens)):
        post = getattr(owner, f"act_postprocess{i + 1}")
        h = post[0](tokens, cls)
        h = h.transpose(1, 2).reshape(h.shape[0], h.shape[2], gh, gw)
        for mod in post[3:]:
            h = mod(h)
        reassembled.append(getattr(scratch, f"layer{i + 1}_rn")(h))
    x = scratch.refinenet4(reassembled[3])
    x = scratch.refinenet3(x, reassembled[2])
    x = scratch.refinenet2(x, reassembled[1])
    x = scratch.refinenet1(x, reassembled[0])
    return scratch.head1(x)


class LSegHead(nn.Module):
    """The DPT head alone: ``act_postprocess{1..4}`` and ``scratch``."""

    def __init__(self, features: int = 256, out_dim: int = 512, vit_width: int = 1024,
                 layer_channels: Tuple[int, ...] = (256, 512, 1024, 1024),
                 device: DeviceLike = "cuda"):
        super().__init__()
        with resolve_device(device):
            for i, ch in enumerate(layer_channels):
                setattr(self, f"act_postprocess{i + 1}", make_postprocess(vit_width, ch, i))
            self.scratch = Scratch(features, out_dim, layer_channels)

    def forward(self, levels, cls_tokens, grid):
        return dpt_head(self, self.scratch, levels, cls_tokens, grid)


class LSegNet(nn.Module):
    """``forward(images (B, 3, H, W) in [0, 1], raw)`` -> (B, out_dim, H/2, W/2)."""

    def __init__(self, features: int = 256, out_dim: int = 512,
                 vit_cfg: ViTConfig = TIMM_VIT_L16_384, hooks: Tuple[int, ...] = HOOK_LAYERS,
                 layer_channels: Tuple[int, ...] = (256, 512, 1024, 1024),
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.hooks = tuple(hooks)
        self.out_dim = out_dim
        self.pretrained = nn.Module()
        self.pretrained.model = VisionTransformer(vit_cfg, act="gelu", device=dev)
        with dev:
            for i, ch in enumerate(layer_channels):
                setattr(self.pretrained, f"act_postprocess{i + 1}",
                        make_postprocess(vit_cfg.width, ch, i))
            self.scratch = Scratch(features, out_dim, layer_channels)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        out = self.pretrained.model(images, out_layers=self.hooks)
        n = out["n_prefix"]
        levels = [out[f"layer{i}"][:, n:, :] for i in self.hooks]
        cls_tokens = [out[f"layer{i}"][:, 0, :] for i in self.hooks]
        return dpt_head(self.pretrained, self.scratch, levels, cls_tokens, out["grid"])


class LSegEncoder:
    """FeatureEncoder: (H, W, 3) render -> (H, W, 512) features, with the
    reference's 480x480 crop, per-pixel L2 norm and resize back.

    ``dtype=torch.bfloat16`` runs the network in bf16 (parameters and
    input cast, as tpugs casts them); the norm and the resize back stay in
    float32. Without ``ckpt`` the weights are random (a warning says so),
    drawn by ``init_flax_like_`` from seed 0, as tpugs draws them from
    ``PRNGKey(0)``."""

    feature_dim = 512
    pixelwise = False

    def __init__(self, ckpt=None, crop_size: int = 480, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = "cuda"):
        net = LSegNet(device=device)
        if ckpt:
            from tpugs_torch.encoders.convert import load_lseg_state_dict

            net.load_state_dict(load_lseg_state_dict(ckpt))
        else:
            init_flax_like_(net, seed=0)
            warnings.warn("LSegEncoder initialized with RANDOM weights (no checkpoint "
                          "given); outputs are not CLIP-aligned.")
        self._setup(net, crop_size, dtype)

    @classmethod
    def from_net(cls, net: LSegNet, crop_size: int = 480,
                 dtype: Optional[torch.dtype] = None) -> "LSegEncoder":
        """The protocol around a network built by the caller (any size)."""
        enc = cls.__new__(cls)
        enc._setup(net, crop_size, dtype)
        return enc

    def _setup(self, net: LSegNet, crop_size: int, dtype: Optional[torch.dtype]) -> None:
        self.net = net.eval() if dtype is None else net.to(dtype).eval()
        self.crop_size = crop_size
        self.dtype = dtype
        self.feature_dim = net.out_dim

    def pre(self, images: torch.Tensor) -> torch.Tensor:
        """(G, H, W, 3) -> (G, 3, crop, crop) in the network's dtype."""
        cs = self.crop_size
        x = resize(images.permute(0, 3, 1, 2), (cs, cs), "bilinear")
        return x if self.dtype is None else x.to(self.dtype)

    @torch.no_grad()
    def network(self, x: torch.Tensor) -> torch.Tensor:
        """(G, 3, crop, crop) -> (G, D, crop/2, crop/2), one image at a time."""
        return torch.cat([self.net(x[i:i + 1]) for i in range(x.shape[0])])

    @staticmethod
    def post(feats: torch.Tensor, size: Tuple[int, int],
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Per-pixel L2 norm in float32, resize to ``size``: (G, h, w, D). The
        resize runs channels-last, so its output is already (G, h, w, D) in
        memory and the cast to ``out_dtype`` is the only other pass."""
        f = feats.float()
        f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-8)
        f = resize(f.contiguous(memory_format=torch.channels_last), size, "bilinear")
        return f.permute(0, 2, 3, 1).to(out_dtype, memory_format=torch.contiguous_format)

    def staged_apply(self, rgbs: torch.Tensor) -> torch.Tensor:
        """(G, H, W, 3) -> (G, H, W, D) bfloat16: the batched pre-resize,
        the network per image, then the norm and the resize back."""
        return self.post(self.network(self.pre(rgbs)), rgbs.shape[1:3], torch.bfloat16)

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) -> (H, W, D) float32."""
        return self.post(self.network(self.pre(image[None])), image.shape[:2])[0]


class TextEncoder:
    """CLIP text embeddings for query prompts (reference ``segment.py:42-52``):
    the BPE tokenizer and the text tower of an LSeg/CLIP checkpoint."""

    def __init__(self, ckpt: Optional[str], bpe_path: Optional[str],
                 device: DeviceLike = "cuda"):
        from tpugs_torch.encoders.clip_text import CLIPTextTower, SimpleTokenizer
        from tpugs_torch.encoders.convert import load_clip_text_state_dict

        dev = resolve_device(device)
        if ckpt is None or bpe_path is None:
            raise FileNotFoundError(
                "Text queries need the CLIP text tower checkpoint and BPE "
                "merges file (offline environment). Use exemplar-feature "
                "queries (--pos-idx) or supply --encoder-ckpt/--bpe-path.")
        self.tokenizer = SimpleTokenizer(bpe_path)
        self.tower = CLIPTextTower(device=dev)
        self.tower.load_state_dict(load_clip_text_state_dict(ckpt))
        self.tower.eval()
        self.device = dev

    @torch.no_grad()
    def __call__(self, prompts: List[str]) -> torch.Tensor:
        from tpugs_torch.encoders.clip_text import tokenize

        tokens = torch.from_numpy(tokenize(self.tokenizer, list(prompts))).to(self.device)
        return self.tower(tokens.long())


def encode_text(prompts, ckpt: Optional[str] = None, bpe_path: Optional[str] = None,
                device: DeviceLike = "cuda") -> torch.Tensor:
    """(P, 512) CLIP text embeddings of ``prompts``; raises
    FileNotFoundError without the checkpoint or the BPE file."""
    return TextEncoder(ckpt, bpe_path, device)(prompts)
