"""Scene normalization transforms. Counterpart: ``tpugs/train/normalize.py``
(the reference's ``f3dgs/datasets/normalize.py``), a numpy copy.

``similarity_from_cameras`` — up-axis alignment from camera poses,
focus-point recentering, median-distance rescale (reference ``:4-63``).
``align_principle_axes``    — PCA alignment of the point cloud (``:66-97``).
Host-side numpy; applied once at dataset load.
"""

from __future__ import annotations

import numpy as np


def similarity_from_cameras(
    c2w: np.ndarray, strict_scaling: bool = False, center_method: str = "focus"
) -> np.ndarray:
    """(N, 4, 4) camera-to-world poses -> (4, 4) similarity transform."""
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    # Rotate the world so the average camera "up" becomes +z.
    ups = np.sum(R * np.array([0, -1.0, 0]), axis=-1)
    world_up = np.mean(ups, axis=0)
    world_up /= np.linalg.norm(world_up)

    up_camspace = np.array([0.0, -1.0, 0.0])
    c = (up_camspace * world_up).sum()
    cross = np.cross(world_up, up_camspace)
    skew = np.array(
        [
            [0.0, -cross[2], cross[1]],
            [cross[2], 0.0, -cross[0]],
            [-cross[1], cross[0], 0.0],
        ]
    )
    if c > -1:
        R_align = np.eye(3) + skew + skew @ skew * 1 / (1 + c)
    else:  # cameras pointing straight down
        R_align = np.array([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])

    R = R_align @ R
    fwds = np.sum(R * np.array([0, 0.0, 1.0]), axis=-1)
    t = (R_align @ t[..., None])[..., 0]

    if center_method == "focus":
        # Translate to the point closest to all camera optical axes.
        nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
        translate = -np.median(nearest, axis=0)
    elif center_method == "poses":
        translate = -np.median(t, axis=0)
    else:
        raise ValueError(f"unknown center_method {center_method}")

    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = R_align

    # Rescale so the (max or median) camera distance is 1.
    scale_fn = np.max if strict_scaling else np.median
    scale = 1.0 / scale_fn(np.linalg.norm(t + translate, axis=-1))
    transform[:3, :] *= scale
    return transform


def align_principle_axes(point_cloud: np.ndarray) -> np.ndarray:
    """(M, 3) points -> (4, 4) rotation aligning principal axes to xyz
    (largest eigenvalue -> z), z flipped to keep most points below."""
    centroid = np.median(point_cloud, axis=0)
    translated = point_cloud - centroid
    covariance = np.cov(translated, rowvar=False)
    eigenvalues, eigenvectors = np.linalg.eigh(covariance)
    order = eigenvalues.argsort()[::-1]
    eigenvectors = eigenvectors[:, order]
    if np.linalg.det(eigenvectors) < 0:
        eigenvectors[:, 2] *= -1
    rotation = eigenvectors.T
    transform = np.eye(4)
    transform[:3, :3] = rotation
    transform[:3, 3] = -rotation @ centroid
    return transform


def transform_points(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def transform_cameras(matrix: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """Apply a similarity to (N, 4, 4) camera-to-world poses, renormalizing
    the rotation scale."""
    out = matrix @ c2w
    scaling = np.linalg.norm(out[:, 0, :3], axis=1)
    out[:, :3, :3] = out[:, :3, :3] / scaling[:, None, None]
    return out
