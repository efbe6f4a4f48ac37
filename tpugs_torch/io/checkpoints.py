"""Checkpoint loading and saving in the three reference formats and npz.
Counterpart: ``tpugs/io/checkpoints.py``.

  * ``gsplat`` — torch ``.pt`` with a ``model["splats"]`` dict of
    means/quats/scales/opacities/sh0/shN (and features/conv for a
    feature-3DGS scene);
  * ``inria``  — torch ``.pt`` tuple (model_params, iteration) of the
    original 3DGS code;
  * ``ply``    — the Inria point-cloud export with f_dc_*/f_rest_* fields;
  * ``.npz``   — the same arrays as the gsplat dict, in numpy.

Scenes load as float32 onto ``device``. ``load_checkpoint`` also parses the
COLMAP project and builds the camera batch as the reference does: one
shared pinhole K divided by ``data_factor``, the render size
``int(2 cx)`` x ``int(2 cy)``, cameras in image-name order, and on a rig of
several cameras of one render size each image's own K.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from tpugs_torch.convert import scene_from_numpy
from tpugs_torch.core.camera import Camera, cameras_from_colmap
from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.io.colmap import SceneManager
from tpugs_torch.io.ply import read_ply, write_ply


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _scene_from_dict(d: dict, device: DeviceLike) -> GaussianScene:
    """A scene from the gsplat key names (scales, opacities, conv)."""
    return scene_from_numpy({
        "means": _to_np(d["means"]),
        "quats": _to_np(d["quats"]),
        "log_scales": _to_np(d["scales"]),
        "logit_opacities": _to_np(d["opacities"]).reshape(-1),
        "sh0": _to_np(d["sh0"]),
        "shN": _to_np(d["shN"]),
        "features": None if d.get("features") is None else _to_np(d["features"]),
        "feature_proj": None if d.get("conv") is None else _to_np(d["conv"]),
    }, device=device)


def _scene_to_dict(scene: GaussianScene) -> dict:
    """The scene's arrays under the gsplat key names, float32 numpy."""
    out = {
        "means": scene.means, "quats": scene.quats, "scales": scene.log_scales,
        "opacities": scene.logit_opacities, "sh0": scene.sh0, "shN": scene.shN,
        "features": scene.features, "conv": scene.feature_proj,
    }
    return {k: _to_np(v).astype(np.float32) for k, v in out.items() if v is not None}


def load_scene_pt(path: str, format: str = "gsplat", device: DeviceLike = "cuda") -> GaussianScene:
    """Load a torch checkpoint (gsplat or inria layout)."""
    dev = resolve_device(device)
    model = torch.load(path, map_location="cpu", weights_only=False)
    if format == "gsplat":
        sp = model["splats"]
        return _scene_from_dict({k: sp.get(k) for k in (
            "means", "quats", "scales", "opacities", "sh0", "shN", "features", "conv")}, dev)
    if format == "inria":
        model_params, _ = model
        # (active_sh_degree, means, features_dc, features_rest, scaling,
        #  rotation, opacity, ...)
        return _scene_from_dict({
            "means": model_params[1],
            "sh0": model_params[2],
            "shN": model_params[3],
            "scales": model_params[4],
            "quats": model_params[5],
            "opacities": model_params[6],
        }, dev)
    raise ValueError(f"unknown torch checkpoint format {format!r}")


def load_scene_ply(path: str, sh_degree: int = 3, device: DeviceLike = "cuda") -> GaussianScene:
    dev = resolve_device(device)
    fields = read_ply(path)
    n_rest = 3 * ((sh_degree + 1) ** 2 - 1)
    means = np.stack([fields["x"], fields["y"], fields["z"]], axis=1)
    sh0 = np.stack([fields[f"f_dc_{i}"] for i in range(3)], axis=1).reshape(-1, 1, 3)
    # Inria PLY stores f_rest channel-major: (3, K) flattened.
    rest = np.stack([fields[f"f_rest_{i}"] for i in range(n_rest)], axis=1)
    shN = rest.reshape(-1, 3, n_rest // 3).transpose(0, 2, 1)
    scales = np.stack([fields[f"scale_{i}"] for i in range(3)], axis=1)
    quats = np.stack([fields[f"rot_{i}"] for i in range(4)], axis=1)
    return _scene_from_dict({"means": means, "quats": quats, "scales": scales,
                             "opacities": fields["opacity"], "sh0": sh0, "shN": shN}, dev)


def save_scene_ply(scene: GaussianScene, path: str) -> None:
    """Inria-layout PLY export (round-trips through ``load_scene_ply``)."""
    d = _scene_to_dict(scene)
    n = scene.num_gaussians
    means, sh0 = d["means"], d["sh0"].reshape(n, 3)
    rest = d["shN"].transpose(0, 2, 1).reshape(n, -1)  # channel-major
    fields = {"x": means[:, 0], "y": means[:, 1], "z": means[:, 2]}
    fields.update({f"f_dc_{i}": sh0[:, i] for i in range(3)})
    fields.update({f"f_rest_{i}": rest[:, i] for i in range(rest.shape[1])})
    fields["opacity"] = d["opacities"]
    fields.update({f"scale_{i}": d["scales"][:, i] for i in range(3)})
    fields.update({f"rot_{i}": d["quats"][:, i] for i in range(4)})
    write_ply(path, fields)


def load_scene_npz(path: str, device: DeviceLike = "cuda") -> GaussianScene:
    dev = resolve_device(device)
    with np.load(path) as d:
        return _scene_from_dict({k: d[k] if k in d else None for k in (
            "means", "quats", "scales", "opacities", "sh0", "shN", "features", "conv")}, dev)


def save_scene_npz(scene: GaussianScene, path: str) -> None:
    np.savez(path, **_scene_to_dict(scene))


def save_scene_pt(scene: GaussianScene, path: str) -> None:
    """gsplat-format torch checkpoint: ``{"splats": {...}}`` of CPU tensors."""
    torch.save({"splats": {k: torch.from_numpy(v) for k, v in _scene_to_dict(scene).items()}},
               path)


def load_checkpoint(
    checkpoint: str,
    data_dir: str,
    format: str = "gsplat",
    data_factor: int = 1,
    device: DeviceLike = "cuda",
) -> Tuple[GaussianScene, Camera, SceneManager]:
    """Full load: (scene, cameras, the COLMAP ``SceneManager``) of
    ``data_dir/sparse/0``, the scene and cameras on ``device``; cameras in
    image-name order."""
    dev = resolve_device(device)
    colmap = SceneManager(os.path.join(data_dir, "sparse/0")).load_all()

    if format in ("gsplat", "inria"):
        scene = load_scene_pt(checkpoint, format, dev)
    elif format == "ply":
        scene = load_scene_ply(checkpoint, device=dev)
    elif format == "npz":
        scene = load_scene_npz(checkpoint, dev)
    else:
        raise ValueError("Invalid Gaussian splatting format")

    cam = next(iter(colmap.cameras.values()))
    K = cam.K.astype(np.float32)
    K[:2, :] /= data_factor
    # int() truncation, not round(): the reference derives the render size
    # as int(cx*2) x int(cy*2), which differs by one pixel for a
    # non-integer cx or cy after the data_factor division
    width = int(K[0, 2] * 2)
    height = int(K[1, 2] * 2)
    images = sorted(colmap.images.values(), key=lambda im: im.name)
    cameras = cameras_from_colmap(images, K, width, height, dev)
    if len(colmap.cameras) > 1:
        # A rig of several cameras: each image gets its own camera's
        # pinhole K, as long as every camera shares the render size
        sizes = {
            (int(c.K[0, 2] * 2 / data_factor), int(c.K[1, 2] * 2 / data_factor))
            for c in colmap.cameras.values()
        }
        if len(sizes) == 1:
            Ks = np.stack([colmap.cameras[im.camera_id].K.astype(np.float32) for im in images])
            Ks[:, :2, :] /= data_factor
            cameras = dataclasses.replace(cameras, Ks=torch.from_numpy(Ks).to(dev))
    return scene, cameras, colmap


def save_checkpoint(scene: GaussianScene, path: str) -> None:
    """Format chosen by extension: .pt (gsplat), .ply, else .npz."""
    if path.endswith(".pt"):
        save_scene_pt(scene, path)
    elif path.endswith(".ply"):
        save_scene_ply(scene, path)
    else:
        save_scene_npz(scene, path if path.endswith(".npz") else path + ".npz")
