"""Numpy arrays in, port state out (no counterpart in ``tpugs``).

The tests hand one numpy-seeded input to both packages through these:
``scene_from_numpy`` takes what ``np.asarray`` gives on each field of a
``tpugs`` ``GaussianScene`` (the trainer's ``features`` and ``feature_proj``
where present and not None); ``cameras_from_numpy`` a rig's viewmats and
intrinsics; ``linear_encoder_from_numpy`` a ``LinearRGBEncoder``'s
``(3, D)`` projection.
"""

from __future__ import annotations

from typing import Mapping

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
