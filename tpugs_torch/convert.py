"""Numpy arrays in, port state out (no counterpart in ``tpugs``).

The tests hand one numpy-seeded input to both packages through these:
``scene_from_numpy`` takes what ``np.asarray`` gives on each field of a
``tpugs`` ``GaussianScene`` (the trainer's ``features`` and ``feature_proj``
where present and not None); ``cameras_from_numpy`` a rig's viewmats and
intrinsics; ``linear_encoder_from_numpy`` a ``LinearRGBEncoder``'s
``(3, D)`` projection; ``vit_from_flax``, ``lseg_from_flax``,
``dino_from_flax`` and ``clip_text_from_flax`` a Flax param tree of the
encoders (numpy leaves, ``block{i}`` or stacked ``blocks`` layout), giving
the port's state dict: tpugs' checkpoint key maps
(``tpugs/encoders/convert.py``) run in reverse.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from tpugs_torch.core.camera import Camera
from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.encoders.base import LinearRGBEncoder

SCENE_FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh0", "shN")
FEATURE_FIELDS = ("features", "feature_proj")  # optional: None on scenes without features


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def scene_from_numpy(
    arrays: Mapping[str, np.ndarray], device: DeviceLike = "cuda"
) -> GaussianScene:
    dev = resolve_device(device)
    missing = [k for k in SCENE_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"scene arrays lack {missing}")
    fields = {k: _f32(arrays[k], dev) for k in SCENE_FIELDS}
    for k in FEATURE_FIELDS:
        if arrays.get(k) is not None:
            fields[k] = _f32(arrays[k], dev)
    return GaussianScene(**fields)


def scene_to_numpy(scene: GaussianScene) -> dict:
    """Every field that is not None, as float32 numpy arrays."""
    return {k: getattr(scene, k).detach().cpu().numpy()
            for k in SCENE_FIELDS + FEATURE_FIELDS if getattr(scene, k) is not None}


def cameras_from_numpy(
    viewmats, Ks, width: int, height: int, device: DeviceLike = "cuda"
) -> Camera:
    dev = resolve_device(device)
    vm = _f32(viewmats, dev)
    ks = _f32(Ks, dev)
    if vm.ndim != 3 or vm.shape[1:] != (4, 4) or ks.shape != (vm.shape[0], 3, 3):
        raise ValueError(
            f"viewmats (C, 4, 4) and Ks (C, 3, 3) expected, got "
            f"{tuple(vm.shape)} and {tuple(ks.shape)}"
        )
    return Camera(vm, ks, int(width), int(height))


def linear_encoder_from_numpy(
    proj, normalize: bool = True, device: DeviceLike = "cuda"
) -> LinearRGBEncoder:
    dev = resolve_device(device)
    p = _f32(proj, dev)
    if p.ndim != 2 or p.shape[0] != 3:
        raise ValueError(f"projection (3, D) expected, got {tuple(p.shape)}")
    return LinearRGBEncoder.from_projection(p, normalize=normalize)


# ---------------------------------------------- Flax params -> state dicts


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _unwrap(params: Mapping) -> Mapping:
    return params["params"] if "params" in params and len(params) == 1 else params


def _dense(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """Flax Dense (in, out) -> torch Linear (out, in)."""
    return {prefix + ".weight": _t(p["kernel"]).T.contiguous(), prefix + ".bias": _t(p["bias"])}


def _norm(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {prefix + ".weight": _t(p["scale"]), prefix + ".bias": _t(p["bias"])}


def _conv(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """Flax Conv HWIO -> torch OIHW. Flax's ConvTranspose with
    ``transpose_kernel=True`` keeps (kh, kw, out, in), which the same
    permutation takes to torch's ConvTranspose2d (in, out, kh, kw): the
    inverse of tpugs' ``_conv_transpose``."""
    out = {prefix + ".weight": _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()}
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])
    return out


def block_from_flax(p: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """One ViT ``Block``'s params -> ``blocks.{i}``'s keys under ``prefix``."""
    sd = {**_norm(p["norm1"], prefix + "norm1"),
          **_dense(p["attn"]["qkv"], prefix + "attn.qkv"),
          **_dense(p["attn"]["proj"], prefix + "attn.proj"),
          **_norm(p["norm2"], prefix + "norm2"),
          **_dense(p["mlp"]["fc1"], prefix + "mlp.fc1"),
          **_dense(p["mlp"]["fc2"], prefix + "mlp.fc2")}
    for ls in ("ls1", "ls2"):
        if ls in p:
            sd[f"{prefix}{ls}.gamma"] = _t(p[ls])
    return sd


def _blocks(vit: Mapping):
    """The per-block param trees, from ``block{i}`` or a stacked ``blocks``."""
    if "blocks" in vit:
        stacked = vit["blocks"]

        def take(tree, i):
            return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                    for k, v in tree.items()}

        n = len(np.asarray(stacked["norm1"]["scale"]))
        return [take(stacked, i) for i in range(n)]
    n = sum(1 for k in vit if k.startswith("block") and k[5:].isdigit())
    return [vit[f"block{i}"] for i in range(n)]


def vit_from_flax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """tpugs ``VisionTransformer`` params -> ``encoders/vit.py``'s state dict
    (timm layout) under ``prefix``."""
    vit = _unwrap(params)
    sd = _conv(vit["patch_embed"], prefix + "patch_embed.proj")
    if "class_token" in vit:
        sd[prefix + "cls_token"] = _t(vit["class_token"])
    if "register_tokens" in vit:
        sd[prefix + "register_tokens"] = _t(vit["register_tokens"])
    sd[prefix + "pos_embed"] = _t(vit["pos_embed"])
    if "ln_pre" in vit:
        sd.update(_norm(vit["ln_pre"], prefix + "norm_pre"))
    for i, block in enumerate(_blocks(vit)):
        sd.update(block_from_flax(block, f"{prefix}blocks.{i}."))
    sd.update(_norm(vit["ln_post"], prefix + "norm"))
    return sd


def dino_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """tpugs ``DinoEncoder`` params -> DINOv2's timm layout (no prefix)."""
    return vit_from_flax(params)


def lseg_head_from_flax(params: Mapping, post_prefix: str = "") -> Dict[str, torch.Tensor]:
    """tpugs ``LSegHead`` params -> ``LSegHead``'s state dict
    (``act_postprocess{1..4}`` under ``post_prefix``, ``scratch.*``)."""
    head = _unwrap(params)
    sd = {}
    for i in range(4):
        ap = f"{post_prefix}act_postprocess{i + 1}"
        sd.update(_dense(head[f"read{i}"], ap + ".0.project.0"))
        sd.update(_conv(head[f"proj{i}"], ap + ".3"))
        sd.update(_conv(head[f"rn{i}"], f"scratch.layer{i + 1}_rn"))
    sd.update(_conv(head["up0"], post_prefix + "act_postprocess1.4"))
    sd.update(_conv(head["up1"], post_prefix + "act_postprocess2.4"))
    sd.update(_conv(head["down3"], post_prefix + "act_postprocess4.4"))
    for i in range(4):
        fuse, rn = head[f"fuse{i}"], f"scratch.refinenet{i + 1}"
        for unit, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            if unit in fuse:
                for c in ("conv1", "conv2"):
                    sd.update(_conv(fuse[unit][c], f"{rn}.{name}.{c}"))
        sd.update(_conv(fuse["out_conv"], rn + ".out_conv"))
    sd.update(_conv(head["head1"], "scratch.head1"))
    return sd


def lseg_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """tpugs ``LSegNet`` params -> lang-seg's layout (``pretrained.model.*``,
    ``pretrained.act_postprocess{1..4}``, ``scratch.*``)."""
    p = _unwrap(params)
    return {**vit_from_flax(p["vit"], "pretrained.model."),
            **lseg_head_from_flax(p["head"], "pretrained.")}


def clip_text_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """tpugs ``CLIPTextTower`` params -> OpenAI CLIP's text layout; the
    fused ``in_proj_weight`` is the Dense kernel transposed back."""
    p = _unwrap(params)
    sd = {"token_embedding.weight": _t(p["token_embedding"]["embedding"]),
          "positional_embedding": _t(p["pos_embed"]),
          "text_projection": _t(p["text_projection"]),
          **_norm(p["ln_final"], "ln_final")}
    n = sum(1 for k in p if k.startswith("ln1_"))
    for i in range(n):
        b = f"transformer.resblocks.{i}."
        sd.update(_norm(p[f"ln1_{i}"], b + "ln_1"))
        sd[b + "attn.in_proj_weight"] = _t(p[f"attn_qkv_{i}"]["kernel"]).T.contiguous()
        sd[b + "attn.in_proj_bias"] = _t(p[f"attn_qkv_{i}"]["bias"])
        sd.update(_dense(p[f"attn_proj_{i}"], b + "attn.out_proj"))
        sd.update(_norm(p[f"ln2_{i}"], b + "ln_2"))
        sd.update(_dense(p[f"mlp_fc_{i}"], b + "mlp.c_fc"))
        sd.update(_dense(p[f"mlp_proj_{i}"], b + "mlp.c_proj"))
    return sd
