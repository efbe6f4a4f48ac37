"""EWA projection of 3D Gaussians to screen space. Counterpart:
``tpugs/raster/projection.py:27-233`` (``Projected``, ``ProjectionConfig``,
``project``, ``view_directions``).

Dense over N, elementwise torch. Outputs per Gaussian: 2D means, conic
(inverse 2D covariance, upper triangle), depth, conservative radius, the
effective opacity and the validity mask (near/far, positive determinant,
``radius_clip``, on-screen, and the ``opacity >= 1/255`` cut), plus the
two sub-cutoff bounds (``cut_r2``, ``sig_cut``) the planner culls with.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

ALPHA_CLIP_MIN = 1.0 / 255.0


class Projected(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixel coordinates
    conics: torch.Tensor  # (N, 3) upper triangle of the inverse 2D cov (a, b, c)
    depths: torch.Tensor  # (N,) camera-space z
    radii: torch.Tensor  # (N,) conservative pixel radius (0 if culled)
    opacities: torch.Tensor  # (N,) effective opacity
    valid: torch.Tensor  # (N,) bool
    cut_r2: torch.Tensor  # (N,) squared radius beyond which alpha < 1/255
    sig_cut: torch.Tensor  # (N,) sigma threshold ln(255*op); -1 if invalid


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    eps2d: float = 0.3  # screen-space low-pass filter (EWA dilation)
    near_plane: float = 0.01
    far_plane: float = 1e10
    radius_clip: float = 0.0  # cull Gaussians with radius <= this (px)
    antialiased: bool = False  # opacity compensation instead of dilation
    sigma_factor: float = 3.0  # splat extent in stddevs


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz (unnormalised ok) -> (N, 3, 3)."""
    q = quats / (torch.linalg.vector_norm(quats, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def covariance_3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T; scales are activated stddevs (N, 3)."""
    M = quat_to_rotmat(quats) * scales[..., None, :]  # R @ diag(s)
    return M @ M.transpose(-1, -2)


def project(
    means: torch.Tensor,  # (N, 3)
    quats: torch.Tensor,  # (N, 4)
    scales: torch.Tensor,  # (N, 3) activated
    opacities: torch.Tensor,  # (N,) activated
    viewmat: torch.Tensor,  # (4, 4) world-to-camera
    K: torch.Tensor,  # (3, 3)
    width: int,
    height: int,
    config: ProjectionConfig = ProjectionConfig(),
) -> Projected:
    R_wc = viewmat[:3, :3]
    t_wc = viewmat[:3, 3]
    p_cam = means @ R_wc.T + t_wc  # (N, 3)
    z = p_cam[:, 2]

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    # Guard z for the division; culled later by the near-plane mask.
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    x_ndc = p_cam[:, 0] / zs
    y_ndc = p_cam[:, 1] / zs
    mean_x = fx * x_ndc + cx
    mean_y = fy * y_ndc + cy
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    # EWA: cov2d = J W Sigma W^T J^T, tangent-plane extent clamped to the
    # frustum extended by 30%.
    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    tx = zs * torch.minimum(torch.maximum(x_ndc, -lim_x), lim_x)
    ty = zs * torch.minimum(torch.maximum(y_ndc, -lim_y), lim_y)

    cov3d = covariance_3d(quats, scales)
    cov_cam = R_wc @ cov3d @ R_wc.T  # (N, 3, 3)

    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    c00, c01, c02 = cov_cam[:, 0, 0], cov_cam[:, 0, 1], cov_cam[:, 0, 2]
    c11, c12, c22 = cov_cam[:, 1, 1], cov_cam[:, 1, 2], cov_cam[:, 2, 2]

    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    det_orig = a * c - b * b
    a_d = a + config.eps2d
    c_d = c + config.eps2d
    det = a_d * c_d - b * b

    if config.antialiased:
        compensation = torch.sqrt(torch.clamp(det_orig / det, min=0.0))
    else:
        compensation = torch.ones_like(det)

    det_safe = torch.where(det <= 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c_d * inv_det, -b * inv_det, a_d * inv_det], dim=-1)

    mid = 0.5 * (a_d + c_d)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    lambda_max = mid + disc
    radius = torch.ceil(config.sigma_factor * torch.sqrt(lambda_max))

    opac = opacities * compensation

    inside = (
        (mean_x + radius > 0)
        & (mean_x - radius < width)
        & (mean_y + radius > 0)
        & (mean_y - radius < height)
    )
    valid = (
        (z > config.near_plane)
        & (z < config.far_plane)
        & (det > 0.0)
        & (radius > config.radius_clip)
        & inside
        & (opac >= ALPHA_CLIP_MIN)
    )
    zero = torch.zeros_like(radius)
    radius = torch.where(valid, radius, zero)
    cut_r2 = 2.0 * lambda_max * torch.log(torch.clamp(255.0 * opac, min=1.0))
    cut_r2 = torch.minimum(cut_r2 * 1.0001, radius * radius)
    cut_r2 = torch.where(valid, cut_r2, zero)
    sig_cut = torch.log(torch.clamp(255.0 * opac, min=1.0))
    sig_cut = torch.where(valid, sig_cut, torch.full_like(sig_cut, -1.0))
    return Projected(
        means2d=means2d,
        conics=conic,
        depths=z,
        radii=radius,
        opacities=opac,
        valid=valid,
        cut_r2=cut_r2,
        sig_cut=sig_cut,
    )


def view_directions(means: torch.Tensor, viewmat: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian viewing directions (world frame) for SH evaluation."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    cam_center = -R.T @ t
    return means - cam_center
