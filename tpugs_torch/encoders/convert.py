"""Public checkpoints -> the port's state dicts. Counterpart:
``tpugs/encoders/convert.py`` (``load_lseg_params``, ``load_dino_params``,
``load_clip_text_params``).

The port's modules keep the public layouts (lang-seg's LSegNet, DINOv2's
timm ViT, OpenAI CLIP's text tower), so loading is a filter: each loader
drops exactly the families tpugs' converter leaves unread and returns the
rest, which the module then takes with ``load_state_dict(strict=True)``.
A missing or unknown key raises there, as tpugs' ``_Tracked.check_consumed``
raises on layout drift. Files are read with ``torch.load(weights_only=True)``,
under ``state_dict`` where the file has one.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Union

import torch

StateDict = Dict[str, torch.Tensor]


def read_state_dict(path_or_dict: Union[str, os.PathLike, Mapping]) -> StateDict:
    if isinstance(path_or_dict, Mapping):
        return dict(path_or_dict)
    sd = torch.load(path_or_dict, map_location="cpu", weights_only=True)
    return dict(sd["state_dict"] if "state_dict" in sd else sd)


def _require(sd: Mapping, keys, what: str) -> None:
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"missing {what} tensors {missing}")


def load_lseg_state_dict(path_or_dict, strict: bool = True) -> StateDict:
    """``LSegNet``'s state dict from ``lseg_minimal_e200.ckpt`` (lang-seg
    layout). Dropped, as tpugs leaves them unread: ``clip_pretrained.*``
    (the text tower is ``load_clip_text_state_dict``'s), ``logit_scale``,
    the unused timm classifier ``pretrained.model.head.*``, and
    ``scratch.refinenet4.resConfUnit1.*``, which DPT never applies. With
    ``strict``, the backbone's and the head's required tensors must be
    there."""
    sd = read_state_dict(path_or_dict)
    if strict:
        bb = "pretrained.model."
        _require(sd, [bb + "cls_token", bb + "pos_embed", bb + "patch_embed.proj.weight",
                      bb + "norm.weight", bb + "blocks.0.norm1.weight"],
                 "backbone (timm ViT under pretrained.model.*)")
        _require(sd, [f"pretrained.act_postprocess{i}.0.project.0.weight" for i in range(1, 5)]
                 + [f"scratch.layer{i}_rn.weight" for i in range(1, 5)]
                 + [f"scratch.refinenet{i}.resConfUnit2.conv1.weight" for i in range(1, 5)]
                 + ["scratch.head1.weight"], "DPT head")
    dropped = ("clip_pretrained.", "logit_scale", "pretrained.model.head.",
               "scratch.refinenet4.resConfUnit1.")
    return {k: v for k, v in sd.items() if not k.startswith(dropped)}


def load_dino_state_dict(path_or_dict, strict: bool = True) -> StateDict:
    """A DINOv2 ``VisionTransformer``'s state dict (timm layout). Only
    ``mask_token`` (masked-image pretraining) is dropped."""
    sd = read_state_dict(path_or_dict)
    if strict:
        _require(sd, ["cls_token", "pos_embed", "patch_embed.proj.weight", "norm.weight",
                      "blocks.0.norm1.weight"], "DINOv2 (timm layout)")
    return {k: v for k, v in sd.items() if k != "mask_token"}


def load_clip_text_state_dict(path_or_dict, prefix: str = "clip_pretrained.",
                              strict: bool = True) -> StateDict:
    """``CLIPTextTower``'s state dict: the keys under ``prefix`` with the
    prefix stripped, less the visual tower (``visual.*``) and CLIP's
    temperature ``logit_scale``."""
    sd = read_state_dict(path_or_dict)
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if strict:
        _require(sd, ["token_embedding.weight", "positional_embedding", "ln_final.weight",
                      "text_projection", "transformer.resblocks.0.ln_1.weight"],
                 f"CLIP text tower (under {prefix!r})")
    return {k: v for k, v in sd.items() if not k.startswith(("visual.", "logit_scale"))}
