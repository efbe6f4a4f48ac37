"""Camera trajectory generation. Counterpart: ``tpugs/train/traj.py``, a
numpy and scipy copy (the reference's ``f3dgs/datasets/traj.py``):
B-spline interpolated paths through keyframe poses plus ellipse orbits —
used by the trainer's ``render_traj`` video output."""

from __future__ import annotations

import numpy as np
import scipy.interpolate


def generate_interpolated_path(
    poses: np.ndarray,  # (N, 3, 4) or (N, 4, 4) c2w
    n_interp: int,
    spline_degree: int = 5,
    smoothness: float = 0.03,
    rot_weight: float = 0.1,
) -> np.ndarray:
    """Smooth spline path through keyframes -> (n_interp * (N-1), 3, 4)."""
    poses = np.asarray(poses)[:, :3, :4]

    def poses_to_points(poses, dist):
        """Pose -> (position, lookat-point, up-point) triple."""
        pos = poses[:, :3, -1]
        lookat = poses[:, :3, -1] - dist * poses[:, :3, 2]
        up = poses[:, :3, -1] + dist * poses[:, :3, 1]
        return np.stack([pos, lookat, up], 1)

    def points_to_poses(points):
        return np.array(
            [_viewmatrix(p - l, u - p, p) for p, l, u in points]
        )

    points = poses_to_points(poses, dist=rot_weight)
    n = points.shape[0]
    k = min(spline_degree, n - 1)
    sh = points.shape
    pts = points.reshape(n, -1)
    tck, _ = scipy.interpolate.splprep(pts.T, k=k, s=smoothness)
    u = np.linspace(0, 1, n_interp * (n - 1), endpoint=False)
    new_points = np.array(scipy.interpolate.splev(u, tck)).T
    new_points = new_points.reshape((-1,) + sh[1:])
    return points_to_poses(new_points)


def _viewmatrix(lookdir, up, position):
    """Construct a (3, 4) camera-to-world from viewing direction/up."""
    vec2 = _normalize(lookdir)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def _normalize(x):
    return x / (np.linalg.norm(x) + 1e-12)


def generate_ellipse_path_z(
    poses: np.ndarray,  # (N, 3/4, 4) c2w
    n_frames: int = 120,
    variation: float = 0.0,
    phase: float = 0.0,
    height_percentile: float = 50.0,
) -> np.ndarray:
    """Elliptical orbit in the xy-plane around the scene focus, constant-ish
    z (reference ``traj.py:34-106``). Returns (n_frames, 3, 4) c2w."""
    poses = np.asarray(poses)[:, :3, :4]
    center = np.mean(poses[:, :3, 3], axis=0)
    offset = np.array([center[0], center[1], 0.0])
    sc_x = np.percentile(np.abs(poses[:, 0, 3] - offset[0]), 90)
    sc_y = np.percentile(np.abs(poses[:, 1, 3] - offset[1]), 90)
    z_height = np.percentile(poses[:, 2, 3], height_percentile)

    t = np.linspace(0, 2 * np.pi, n_frames, endpoint=False) + phase
    positions = np.stack(
        [
            offset[0] + sc_x * np.cos(t),
            offset[1] + sc_y * np.sin(t),
            np.full_like(t, z_height)
            + variation * np.sin(2 * t) * (sc_x + sc_y) / 2,
        ],
        axis=1,
    )
    lookat = center
    up = np.array([0.0, 0.0, 1.0])
    return np.array(
        [_viewmatrix(lookat - p, up, p) for p in positions]
    )


def generate_ellipse_path_y(
    poses: np.ndarray, n_frames: int = 120, variation: float = 0.0,
    phase: float = 0.0,
) -> np.ndarray:
    """Ellipse in the xz-plane (y-up captures, reference ``:109-155``)."""
    poses = np.asarray(poses)[:, :3, :4]
    center = np.mean(poses[:, :3, 3], axis=0)
    sc_x = np.percentile(np.abs(poses[:, 0, 3] - center[0]), 90)
    sc_z = np.percentile(np.abs(poses[:, 2, 3] - center[2]), 90)
    y_height = np.median(poses[:, 1, 3])
    t = np.linspace(0, 2 * np.pi, n_frames, endpoint=False) + phase
    positions = np.stack(
        [
            center[0] + sc_x * np.cos(t),
            np.full_like(t, y_height)
            + variation * np.sin(2 * t) * (sc_x + sc_z) / 2,
            center[2] + sc_z * np.sin(t),
        ],
        axis=1,
    )
    up = np.array([0.0, -1.0, 0.0])
    return np.array(
        [_viewmatrix(center - p, up, p) for p in positions]
    )


def c2w_to_viewmat(c2w: np.ndarray) -> np.ndarray:
    """(3/4, 4) camera-to-world -> (4, 4) world-to-camera."""
    m = np.eye(4)
    m[:3, :4] = np.asarray(c2w)[:3, :4]
    R = m[:3, :3]
    t = m[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out
