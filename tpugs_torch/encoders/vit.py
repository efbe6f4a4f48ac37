"""Vision Transformer shared by the LSeg (timm ViT-L/16) and DINOv2
(ViT-L/14 + register tokens) encoders. Counterpart: ``tpugs/encoders/vit.py``.

Modules take images in NCHW and keep the timm state-dict layout
(``patch_embed.proj``, ``cls_token``, ``register_tokens``, ``pos_embed``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2,ls1.gamma,
ls2.gamma}``, ``norm``), so public checkpoints load with
``load_state_dict``. Attention is the plain ``softmax(q k^T / sqrt(d)) v``
in ``torch.matmul``, as tpugs computes it. tpugs' ``scan_blocks`` and
``stack_block_params`` exist for its compile service; the blocks here run
as a loop, and ``tpugs_torch/convert.py::vit_from_flax`` reads either
layout.

``init_flax_like_`` draws every tensor from ``np.random.default_rng(seed)``
with the distribution of the Flax initializer tpugs uses, so random
activations have tpugs' scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.encoders.resize import resize


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 480
    patch_size: int = 16
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 0  # DINOv2-reg: 4
    use_class_token: bool = True
    pre_norm: bool = False  # a LayerNorm before the blocks; no patch-embed bias
    layer_norm_eps: float = 1e-5
    layer_scale: bool = False  # DINOv2 blocks scale residuals by ls1/ls2
    pos_interp: str = "bilinear"  # a ``resize`` method

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


CLIP_VIT_L16 = ViTConfig(
    image_size=480, patch_size=16, width=1024, layers=24, heads=16, pre_norm=True,
)
DINOV2_VIT_L14_REG = ViTConfig(
    image_size=896, patch_size=14, width=1024, layers=24, heads=16,
    num_register_tokens=4, layer_norm_eps=1e-6, layer_scale=True, pos_interp="cubic",
)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(1.702 * x) * x


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_ratio: float, act: str = "gelu"):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)
        self.act = act

    def forward(self, x):
        x = self.fc1(x)
        x = F.gelu(x) if self.act == "gelu" else quick_gelu(x)
        return self.fc2(x)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, heads, T, d); ``mask`` False
    entries get -1e9 before the softmax."""
    a = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        a = a.masked_fill(~mask, -1e9)
    return torch.matmul(torch.softmax(a, dim=-1), v)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, C = t.shape
    return t.reshape(B, T, heads, C // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    B, h, T, d = t.shape
    return t.transpose(1, 2).reshape(B, T, h * d)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        q, k, v = (split_heads(t, self.heads) for t in self.qkv(x).chunk(3, dim=-1))
        return self.proj(merge_heads(attention(q, k, v)))


class LayerScale(nn.Module):
    """DINOv2's learned per-channel residual gain (``ls{1,2}.gamma``)."""

    def __init__(self, width: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((width,), 1e-5))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, act: str = "gelu"):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(cfg.width, eps=eps)
        self.attn = Attention(cfg.width, cfg.heads)
        self.norm2 = nn.LayerNorm(cfg.width, eps=eps)
        self.mlp = Mlp(cfg.width, cfg.mlp_ratio, act)
        self.ls1 = LayerScale(cfg.width) if cfg.layer_scale else nn.Identity()
        self.ls2 = LayerScale(cfg.width) if cfg.layer_scale else nn.Identity()

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.width, p, stride=p, bias=not cfg.pre_norm)

    def forward(self, x):
        return self.proj(x)


class VisionTransformer(nn.Module):
    """``forward(images (B, 3, H, W), out_layers)`` returns a dict: the
    token sequence (B, n_prefix + gh*gw, C) after each block in
    ``out_layers`` as ``layer{i}`` (default: the last block), ``final``
    (after ``norm``), ``grid`` (gh, gw) and ``n_prefix`` (class and
    register tokens)."""

    def __init__(self, cfg: ViTConfig, act: str = "gelu", device: DeviceLike = "cuda"):
        super().__init__()
        self.cfg = cfg
        with resolve_device(device):
            self.patch_embed = PatchEmbed(cfg)
            n_cls = 1 if cfg.use_class_token else 0
            if cfg.use_class_token:
                self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
            if cfg.num_register_tokens:
                self.register_tokens = nn.Parameter(
                    torch.zeros(1, cfg.num_register_tokens, cfg.width))
            self.pos_embed = nn.Parameter(torch.zeros(1, n_cls + cfg.grid**2, cfg.width))
            if cfg.pre_norm:
                self.norm_pre = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
            self.blocks = nn.ModuleList(Block(cfg, act) for _ in range(cfg.layers))
            self.norm = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)

    @property
    def n_prefix(self) -> int:
        return int(self.cfg.use_class_token) + self.cfg.num_register_tokens

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # A checkpoint trained at another resolution stores its own grid
        # of positions; take its shape, and interpolate in forward.
        stored = state_dict.get(prefix + "pos_embed")
        if stored is not None and stored.shape != self.pos_embed.shape:
            self.pos_embed = nn.Parameter(self.pos_embed.new_empty(stored.shape))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, images: torch.Tensor,
                out_layers: Optional[Iterable[int]] = None) -> Dict[str, object]:
        cfg = self.cfg
        x = self.patch_embed(images)
        B, C, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        pos = self.pos_embed
        patch_pos = pos[:, 1:] if cfg.use_class_token else pos
        if gh * gw != patch_pos.shape[1]:
            g0 = int(round(patch_pos.shape[1] ** 0.5))
            pp = patch_pos.reshape(1, g0, g0, C).permute(0, 3, 1, 2)
            pp = resize(pp, (gh, gw), cfg.pos_interp)
            patch_pos = pp.permute(0, 2, 3, 1).reshape(1, gh * gw, C)
        x = x + patch_pos
        tokens = []
        if cfg.use_class_token:
            tokens.append((self.cls_token + pos[:, :1]).expand(B, -1, -1))
        if cfg.num_register_tokens:
            tokens.append(self.register_tokens.expand(B, -1, -1))
        if tokens:
            x = torch.cat(tokens + [x], dim=1)
        if cfg.pre_norm:
            x = self.norm_pre(x)
        want = set(out_layers) if out_layers is not None else {cfg.layers - 1}
        out: Dict[str, object] = {}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in want:
                out[f"layer{i}"] = x
        out["final"] = self.norm(x)
        out["grid"] = (gh, gw)
        out["n_prefix"] = self.n_prefix
        return out


def patch_tokens(out: Dict[str, object], layer: str = "final") -> torch.Tensor:
    """(B, gh*gw, C) patch tokens with the class and register tokens stripped."""
    return out[layer][:, out["n_prefix"]:, :]


# ------------------------------------------------------ Flax-like init

# Parameters that are not the weight or bias of a standard layer, by name:
# (distribution, scale) as the Flax modules of tpugs initialise them.
SPECIAL_INIT = {
    "pos_embed": ("normal", 0.02),
    "cls_token": ("zeros", 0.0),
    "register_tokens": ("zeros", 0.0),
    "gamma": ("constant", 1e-5),
    "positional_embedding": ("normal", 0.01),
    "text_projection": ("normal", 0.02),
}


def _truncated_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """Flax's ``lecun_normal`` draw: a standard normal truncated to [-2, 2]
    (redrawn where it falls outside), scaled so the variance is std^2."""
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2
    return x * np.float32(std / 0.87962566103423978)


def _draw(rng, module: nn.Module, pname: str, p: torch.Tensor) -> np.ndarray:
    shape = tuple(p.shape)
    if pname in SPECIAL_INIT:
        kind, s = SPECIAL_INIT[pname]
        if kind == "normal":
            return rng.standard_normal(shape, dtype=np.float32) * np.float32(s)
        return np.full(shape, s, np.float32)
    if isinstance(module, nn.LayerNorm):
        return np.full(shape, 1.0 if pname == "weight" else 0.0, np.float32)
    if pname.endswith("bias"):
        return np.zeros(shape, np.float32)
    if isinstance(module, nn.Embedding):  # Flax Embed: normal, variance 1/width
        return rng.standard_normal(shape, dtype=np.float32) / np.float32(math.sqrt(shape[1]))
    if isinstance(module, nn.ConvTranspose2d):  # (in, out, kh, kw)
        fan_in = shape[0] * shape[2] * shape[3]
    elif isinstance(module, (nn.Linear, nn.Conv2d)) or pname == "in_proj_weight":
        fan_in = int(np.prod(shape[1:]))
    else:
        raise TypeError(f"no Flax initializer known for {type(module).__name__}.{pname}")
    return _truncated_normal(rng, shape, 1.0 / math.sqrt(fan_in))


@torch.no_grad()
def init_flax_like_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Overwrite every parameter of ``module`` in place with a draw from
    ``np.random.default_rng(seed)``, in ``named_parameters`` order, with
    the distribution of tpugs' Flax initializer: dense and conv kernels
    ``lecun_normal`` (truncated normal, variance 1/fan_in), biases 0,
    LayerNorm 1 and 0, embeddings normal with variance 1/width, and the
    parameters of ``SPECIAL_INIT`` by name."""
    rng = np.random.default_rng(seed)
    for mod in module.modules():
        for pname, p in mod.named_parameters(recurse=False):
            p.copy_(torch.from_numpy(_draw(rng, mod, pname, p)))
    return module


def parameter_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
