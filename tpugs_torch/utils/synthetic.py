"""Synthetic scenes, orbit rigs and on-disk COLMAP models. Counterpart:
``tpugs/utils/synthetic.py:18-167`` (``random_scene``, ``lookat_viewmat``,
``write_synthetic_colmap``, ``orbit_cameras``).

The numpy draws are the reference's, in the same order, so both packages
get bit-identical inputs from one seed.
"""

from __future__ import annotations

import os

import numpy as np

from tpugs_torch.convert import cameras_from_numpy, scene_from_numpy
from tpugs_torch.core.camera import Camera, intrinsics_matrix
from tpugs_torch.core.device import DeviceLike
from tpugs_torch.core.scene import GaussianScene


def random_scene_arrays(
    n: int,
    seed: int = 0,
    extent: float = 1.0,
    scale_range=(0.01, 0.05),
    sh_degree: int = 3,
    feature_dim: int | None = None,
) -> dict:
    """The reference's draws as numpy arrays (``random_scene`` fields).
    With ``feature_dim``, a standard-normal (n, feature_dim) "features"
    field is drawn after every other array, so those stay the same."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    log_scales = np.log(
        rng.uniform(scale_range[0], scale_range[1], (n, 3))
    ).astype(np.float32)
    # logits of opacities roughly uniform in (0.3, 0.95)
    opac = rng.uniform(0.3, 0.95, (n,)).astype(np.float32)
    logit_opac = np.log(opac / (1 - opac)).astype(np.float32)
    k_rest = (sh_degree + 1) ** 2 - 1
    sh0 = rng.uniform(-0.5, 1.5, (n, 1, 3)).astype(np.float32)
    shN = (0.1 * rng.normal(size=(n, k_rest, 3))).astype(np.float32)
    arrays = dict(
        means=means,
        quats=quats,
        log_scales=log_scales,
        logit_opacities=logit_opac,
        sh0=sh0,
        shN=shN,
    )
    if feature_dim:
        arrays["features"] = rng.normal(size=(n, feature_dim)).astype(np.float32)
    return arrays


def random_scene(
    n: int,
    seed: int = 0,
    extent: float = 1.0,
    scale_range=(0.01, 0.05),
    sh_degree: int = 3,
    feature_dim: int | None = None,
    device: DeviceLike = "cuda",
) -> GaussianScene:
    arrays = random_scene_arrays(n, seed, extent, scale_range, sh_degree, feature_dim)
    return scene_from_numpy(arrays, device=device)


def lookat_viewmat(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0)):
    """World-to-camera viewmat for a camera at ``eye`` looking at
    ``target``. OpenCV convention: +z forward, +y down. Numpy."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_c2w = np.stack([right, down, fwd], axis=1)  # columns
    R_w2c = R_c2w.T
    t = -R_w2c @ eye
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = R_w2c
    vm[:3, 3] = t
    return vm


def write_synthetic_colmap(
    data_dir: str,
    cams: Camera,
    n_points: int = 100,
    seed: int = 0,
    points: "np.ndarray | None" = None,
    point_rgbs: "np.ndarray | None" = None,
) -> None:
    """Write a COLMAP ``sparse/0`` model of a Camera batch (one PINHOLE
    camera from ``cams.Ks[0]``, images ``frame_0000.jpg``...). ``points``
    (P, 3) world xyz and ``point_rgbs`` (P, 3) uint8 give the point cloud;
    otherwise ``n_points`` random points are drawn from ``seed``."""
    from tpugs_torch.io.colmap import (
        ColmapCamera,
        ColmapImage,
        ColmapPoint3D,
        rotmat_to_qvec,
        write_sparse_model,
    )

    K = cams.Ks[0].detach().cpu().numpy()
    cameras = {
        1: ColmapCamera(1, "PINHOLE", cams.width, cams.height,
                        np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float64))
    }
    viewmats = cams.viewmats.detach().cpu().numpy()
    images = {}
    for i in range(cams.num_cameras):
        vm = viewmats[i]
        images[i + 1] = ColmapImage(
            i + 1, rotmat_to_qvec(vm[:3, :3]), vm[:3, 3].astype(np.float64), 1,
            f"frame_{i:04d}.jpg", np.zeros((0, 2)), np.zeros((0,), np.int64),
        )
    rng = np.random.default_rng(seed)
    if points is None:
        xyz = rng.uniform(-1, 1, (n_points, 3))
        rgb = rng.integers(0, 255, (n_points, 3)).astype(np.uint8)
    else:
        xyz = np.asarray(points, np.float64)
        rgb = (
            np.asarray(point_rgbs, np.uint8)
            if point_rgbs is not None
            else rng.integers(0, 255, (len(xyz), 3)).astype(np.uint8)
        )
    pts3d = {
        int(j + 1): ColmapPoint3D(int(j + 1), xyz[j], rgb[j], 0.5, np.array([1], np.int64),
                                  np.array([0], np.int64))
        for j in range(len(xyz))
    }
    write_sparse_model(os.path.join(data_dir, "sparse/0"), cameras, images, pts3d)


def orbit_arrays(
    n_cams: int,
    width: int,
    height: int,
    radius: float = 3.0,
    fov_deg: float = 60.0,
    elevation: float = 0.35,
):
    """(viewmats (C, 4, 4), Ks (C, 3, 3)) float32 numpy arrays."""
    f = 0.5 * width / np.tan(np.radians(fov_deg) / 2)
    K = intrinsics_matrix(f, f, width / 2, height / 2)
    viewmats = []
    for i in range(n_cams):
        theta = 2 * np.pi * i / max(n_cams, 1)
        eye = (
            radius * np.cos(theta),
            -elevation * radius,
            radius * np.sin(theta),
        )
        viewmats.append(lookat_viewmat(eye))
    return (
        np.stack(viewmats).astype(np.float32),
        np.tile(K[None], (n_cams, 1, 1)).astype(np.float32),
    )


def orbit_cameras(
    n_cams: int,
    width: int,
    height: int,
    radius: float = 3.0,
    fov_deg: float = 60.0,
    elevation: float = 0.35,
    device: DeviceLike = "cuda",
) -> Camera:
    vms, ks = orbit_arrays(n_cams, width, height, radius, fov_deg, elevation)
    return cameras_from_numpy(vms, ks, width, height, device=device)
