"""Synthetic scenes and orbit rigs. Counterpart:
``tpugs/utils/synthetic.py:18-70, 143-167`` (``random_scene``,
``lookat_viewmat``, ``orbit_cameras``).

The numpy draws are the reference's, in the same order, so both packages
get bit-identical inputs from one seed. ``write_synthetic_colmap`` waits
for the I/O slice.
"""

from __future__ import annotations

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
) -> dict:
    """The reference's draws as numpy arrays (``random_scene`` fields)."""
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
    return dict(
        means=means,
        quats=quats,
        log_scales=log_scales,
        logit_opacities=logit_opac,
        sh0=sh0,
        shN=shN,
    )


def random_scene(
    n: int,
    seed: int = 0,
    extent: float = 1.0,
    scale_range=(0.01, 0.05),
    sh_degree: int = 3,
    device: DeviceLike = "cuda",
) -> GaussianScene:
    arrays = random_scene_arrays(n, seed, extent, scale_range, sh_degree)
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
