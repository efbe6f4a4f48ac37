"""Plain PyTorch forward passes of the two encoders, read from a flat dict
of weights (the public state-dict names of timm and lang-seg):

* LSeg (Li et al., ICLR 2022): timm's ViT-L/16 with its hooks after blocks
  5, 11, 17 and 23, DPT's "project" readout and reassembly, four residual
  fusion blocks and the 1x1 head to the CLIP space;
* DINOv2 with registers (Oquab et al. 2023; Darcet et al., ICLR 2024):
  ViT-L/14, four register tokens, LayerScale, the final norm's patch tokens.

Every product goes through ``q``, which rounds its operands: the identity
for the float32 reference, an fp8 rounding for the control. Float32
products run with TF32 off (the caller sets the flags). Departures from
the published networks are those of the program under test, on purpose:
the fusion blocks' 2x upsample is half-pixel bilinear, the resizes follow
``jax.image.resize`` (antialiased when an axis shrinks), and DINOv2's
resize back is half-pixel nearest.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """``jax.image.resize`` of the last two axes of (N, C, H, W) in float32:
    bilinear antialiased unless no axis shrinks, nearest with half-pixel
    centres."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    x = x.float()
    if method == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    grows = size[0] >= x.shape[-2] and size[1] >= x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=not grows)


def _w(w: Weights, name: str) -> torch.Tensor:
    return w[name].float()


def linear(w: Weights, name: str, x: torch.Tensor, q: Round, bias: bool = True) -> torch.Tensor:
    y = q(x) @ q(_w(w, name + ".weight")).T
    return y + _w(w, name + ".bias") if bias else y


def conv(w: Weights, name: str, x: torch.Tensor, q: Round, stride: int = 1, padding: int = 0,
         bias: bool = True) -> torch.Tensor:
    b = _w(w, name + ".bias") if bias else None
    return F.conv2d(q(x), q(_w(w, name + ".weight")), b, stride=stride, padding=padding)


def layer_norm(w: Weights, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], _w(w, name + ".weight"), _w(w, name + ".bias"), eps)


def attention(w: Weights, name: str, x: torch.Tensor, heads: int, q: Round) -> torch.Tensor:
    B, T, C = x.shape
    qkv = linear(w, name + ".qkv", x, q).reshape(B, T, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    qh, kh, vh = qkv[0], qkv[1], qkv[2]
    scores = (q(qh) @ q(kh).transpose(-1, -2)) / math.sqrt(C // heads)
    out = q(torch.softmax(scores, dim=-1)) @ q(vh)
    return linear(w, name + ".proj", out.transpose(1, 2).reshape(B, T, C), q)


def vit(w: Weights, prefix: str, cfg: dict, images: torch.Tensor, q: Round,
        out_layers: Sequence[int] = ()) -> dict:
    """timm/DINOv2 ViT on (B, 3, H, W): the tokens after each block of
    ``out_layers``, the final norm's tokens, the patch grid and the number
    of prefix (class and register) tokens."""
    p = prefix
    eps = cfg["layer_norm_eps"]
    x = conv(w, p + "patch_embed.proj", images, q, stride=cfg["patch_size"])
    B, C, gh, gw = x.shape
    x = x.flatten(2).transpose(1, 2)
    pos = _w(w, p + "pos_embed")
    patch_pos = pos[:, 1:]
    if gh * gw != patch_pos.shape[1]:
        g0 = int(round(patch_pos.shape[1] ** 0.5))
        pp = resize(patch_pos.reshape(1, g0, g0, C).permute(0, 3, 1, 2), (gh, gw),
                    cfg["pos_interp"])
        patch_pos = pp.permute(0, 2, 3, 1).reshape(1, gh * gw, C)
    x = x + patch_pos
    prefix_tokens = [(_w(w, p + "cls_token") + pos[:, :1]).expand(B, -1, -1)]
    if cfg["num_register_tokens"]:
        prefix_tokens.append(_w(w, p + "register_tokens").expand(B, -1, -1))
    x = torch.cat(prefix_tokens + [x], dim=1)
    out = {"grid": (gh, gw), "n_prefix": 1 + cfg["num_register_tokens"]}
    for i in range(cfg["layers"]):
        b = f"{p}blocks.{i}."
        h = attention(w, b + "attn", layer_norm(w, b + "norm1", x, eps), cfg["heads"], q)
        if cfg["layer_scale"]:
            h = h * _w(w, b + "ls1.gamma")
        x = x + h
        h = linear(w, b + "mlp.fc1", layer_norm(w, b + "norm2", x, eps), q)
        h = linear(w, b + "mlp.fc2", F.gelu(h), q)
        if cfg["layer_scale"]:
            h = h * _w(w, b + "ls2.gamma")
        x = x + h
        if i in out_layers:
            out[i] = x
    out["final"] = layer_norm(w, p + "norm", x, eps)
    return out


def _residual_unit(w: Weights, name: str, x: torch.Tensor, q: Round) -> torch.Tensor:
    h = conv(w, name + ".conv1", F.relu(x), q, padding=1)
    return x + conv(w, name + ".conv2", F.relu(h), q, padding=1)


def _fusion(w: Weights, name: str, x: torch.Tensor, skip, q: Round) -> torch.Tensor:
    if skip is not None:
        x = x + _residual_unit(w, name + ".resConfUnit1", skip, q)
    x = _residual_unit(w, name + ".resConfUnit2", x, q)
    x = resize(x, (2 * x.shape[-2], 2 * x.shape[-1]), "bilinear")
    return conv(w, name + ".out_conv", x, q)


def lseg_network(w: Weights, cfg: dict, x: torch.Tensor, q: Round) -> torch.Tensor:
    """(B, 3, crop, crop) -> (B, out_dim, crop/2, crop/2)."""
    hooks = cfg["hooks"]
    out = vit(w, "pretrained.model.", cfg["vit"], x, q, out_layers=hooks)
    gh, gw = out["grid"]
    n = out["n_prefix"]
    levels = []
    for i, layer in enumerate(hooks):
        post = f"pretrained.act_postprocess{i + 1}."
        tokens, cls = out[layer][:, n:], out[layer][:, 0]
        h = linear(w, post + "0.project.0", torch.cat([tokens, cls[:, None].expand_as(tokens)], -1), q)
        h = F.gelu(h).transpose(1, 2).reshape(h.shape[0], -1, gh, gw)
        h = conv(w, post + "3", h, q)
        if i == 0 or i == 1:
            h = F.conv_transpose2d(q(h), q(_w(w, post + "4.weight")), _w(w, post + "4.bias"),
                                   stride=4 if i == 0 else 2)
        elif i == 3:
            h = conv(w, post + "4", h, q, stride=2, padding=1)
        levels.append(conv(w, f"scratch.layer{i + 1}_rn", h, q, padding=1, bias=False))
    x = _fusion(w, "scratch.refinenet4", levels[3], None, q)
    x = _fusion(w, "scratch.refinenet3", x, levels[2], q)
    x = _fusion(w, "scratch.refinenet2", x, levels[1], q)
    x = _fusion(w, "scratch.refinenet1", x, levels[0], q)
    return conv(w, "scratch.head1", x, q)


def lseg_features(w: Weights, cfg: dict, image: torch.Tensor, q: Round = identity) -> torch.Tensor:
    """(H, W, 3) render -> (H, W, out_dim) float32: the crop, the network,
    the per-pixel L2 norm and the bilinear resize back."""
    H, W, _ = image.shape
    cs = cfg["crop_size"]
    x = resize(image.permute(2, 0, 1)[None], (cs, cs), "bilinear")
    f = lseg_network(w, cfg, x, q).float()
    f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-8)
    return resize(f, (H, W), "bilinear")[0].permute(1, 2, 0)


def dino_features(w: Weights, cfg: dict, image: torch.Tensor, q: Round = identity) -> torch.Tensor:
    """(H, W, 3) render -> (H, W, width) float32: the resize to the input
    size, the final norm's patch tokens, the nearest resize back."""
    H, W, _ = image.shape
    s = cfg["image_size"]
    x = resize(image.permute(2, 0, 1)[None], (s, s), "bilinear")
    out = vit(w, "", cfg["vit"], x, q)
    gh, gw = out["grid"]
    tokens = out["final"][:, out["n_prefix"]:]
    f = tokens.transpose(1, 2).reshape(1, -1, gh, gw)
    return resize(f, (H, W), "nearest")[0].permute(1, 2, 0)


FEATURES = {"lseg": lseg_features, "dino": dino_features}


# ------------------------------------------------------ parameter tables

def _vit_params(prefix: str, c: dict) -> List[Tuple[str, tuple, str]]:
    width, p = c["width"], c["patch_size"]
    grid = c["image_size"] // p
    hidden = int(width * c["mlp_ratio"])
    out = [(prefix + "patch_embed.proj.weight", (width, 3, p, p), "fan_in"),
           (prefix + "patch_embed.proj.bias", (width,), "zeros"),
           (prefix + "cls_token", (1, 1, width), "zeros")]
    if c["num_register_tokens"]:
        out.append((prefix + "register_tokens", (1, c["num_register_tokens"], width), "zeros"))
    out.append((prefix + "pos_embed", (1, 1 + grid * grid, width), "pos"))
    for i in range(c["layers"]):
        b = f"{prefix}blocks.{i}."
        out += [(b + "norm1.weight", (width,), "ones"), (b + "norm1.bias", (width,), "zeros"),
                (b + "attn.qkv.weight", (3 * width, width), "fan_in"),
                (b + "attn.qkv.bias", (3 * width,), "zeros"),
                (b + "attn.proj.weight", (width, width), "fan_in"),
                (b + "attn.proj.bias", (width,), "zeros"),
                (b + "norm2.weight", (width,), "ones"), (b + "norm2.bias", (width,), "zeros"),
                (b + "mlp.fc1.weight", (hidden, width), "fan_in"),
                (b + "mlp.fc1.bias", (hidden,), "zeros"),
                (b + "mlp.fc2.weight", (width, hidden), "fan_in"),
                (b + "mlp.fc2.bias", (width,), "zeros")]
        if c["layer_scale"]:
            out += [(b + "ls1.gamma", (width,), "gamma"), (b + "ls2.gamma", (width,), "gamma")]
    out += [(prefix + "norm.weight", (width,), "ones"), (prefix + "norm.bias", (width,), "zeros")]
    return out


def lseg_params(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every LSeg parameter, in lang-seg's names."""
    v, feats = cfg["vit"], cfg["features"]
    width = v["width"]
    out = _vit_params("pretrained.model.", v)
    for i, ch in enumerate(cfg["layer_channels"]):
        post = f"pretrained.act_postprocess{i + 1}."
        out += [(post + "0.project.0.weight", (width, 2 * width), "fan_in"),
                (post + "0.project.0.bias", (width,), "zeros"),
                (post + "3.weight", (ch, width, 1, 1), "fan_in"),
                (post + "3.bias", (ch,), "zeros")]
        if i == 0 or i == 1:
            k = 4 if i == 0 else 2
            out += [(post + "4.weight", (ch, ch, k, k), "fan_in_transposed"),
                    (post + "4.bias", (ch,), "zeros")]
        elif i == 3:
            out += [(post + "4.weight", (ch, ch, 3, 3), "fan_in"), (post + "4.bias", (ch,), "zeros")]
    for i, ch in enumerate(cfg["layer_channels"]):
        out.append((f"scratch.layer{i + 1}_rn.weight", (feats, ch, 3, 3), "fan_in"))
    for r in range(1, 5):
        units = ("resConfUnit1", "resConfUnit2") if r != 4 else ("resConfUnit2",)
        for u in units:
            for cv in ("conv1", "conv2"):
                n = f"scratch.refinenet{r}.{u}.{cv}"
                out += [(n + ".weight", (feats, feats, 3, 3), "fan_in"), (n + ".bias", (feats,), "zeros")]
        n = f"scratch.refinenet{r}.out_conv"
        out += [(n + ".weight", (feats, feats, 1, 1), "fan_in"), (n + ".bias", (feats,), "zeros")]
    out += [("scratch.head1.weight", (cfg["out_dim"], feats, 1, 1), "fan_in"),
            ("scratch.head1.bias", (cfg["out_dim"],), "zeros")]
    return out


def dino_params(cfg: dict) -> List[Tuple[str, tuple, str]]:
    return _vit_params("", cfg["vit"])


PARAMS = {"lseg": lseg_params, "dino": dino_params}


def network_flops(cfg: dict, height: int, width: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one encoder forward at an
    (height, width) render, from the layer shapes: every dense and
    convolution layer and both attention products. Elementwise work,
    norms, softmax and resizes are not counted."""
    v = cfg["vit"]
    C, hidden = v["width"], int(v["width"] * v["mlp_ratio"])
    size = cfg["crop_size"] if cfg["encoder"] == "lseg" else cfg["image_size"]
    g = size // v["patch_size"]
    T = g * g + 1 + v["num_register_tokens"]
    total = 2 * g * g * C * 3 * v["patch_size"] ** 2
    total += v["layers"] * (2 * T * C * (3 * C + C + 2 * hidden) + 4 * T * T * C)
    if cfg["encoder"] != "lseg":
        return total
    f = cfg["features"]
    sizes = (4 * g, 2 * g, g, g // 2 + g % 2)
    for i, ch in enumerate(cfg["layer_channels"]):
        total += 2 * g * g * (2 * C) * C + 2 * g * g * C * ch
        if i == 0:
            total += 2 * g * g * ch * ch * 16
        elif i == 1:
            total += 2 * g * g * ch * ch * 4
        elif i == 3:
            total += 2 * sizes[3] ** 2 * ch * ch * 9
        total += 2 * sizes[i] ** 2 * ch * f * 9
    for r, s in zip((4, 3, 2, 1), (sizes[3], sizes[2], sizes[1], sizes[0])):
        units = 1 if r == 4 else 2
        total += units * 2 * (2 * s * s * f * f * 9)
        total += 2 * (2 * s) ** 2 * f * f
    total += 2 * (2 * sizes[0]) ** 2 * f * cfg["out_dim"]
    return total
