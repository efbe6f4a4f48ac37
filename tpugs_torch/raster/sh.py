"""Real spherical-harmonic colour evaluation, degrees 0..3. Counterpart:
``tpugs/raster/sh.py:38-91``. Colours are ``basis @ coeffs + 0.5``,
clamped at 0."""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit view directions -> (..., (degree+1)^2) basis values."""
    out = [torch.full(dirs.shape[:-1], _C0, dtype=dirs.dtype, device=dirs.device)]
    if degree >= 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def sh_to_color(
    coeffs: torch.Tensor, dirs: torch.Tensor, degree: int
) -> torch.Tensor:
    """coeffs (N, K, 3) with K >= (degree+1)^2; dirs (N, 3), not
    necessarily normalised. Returns (N, 3) clamped to >= 0."""
    dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-12)
    basis = eval_sh_basis(degree, dirs)  # (N, k)
    k = num_sh_bases(degree)
    color = torch.einsum("nk,nkc->nc", basis, coeffs[:, :k, :]) + 0.5
    return torch.clamp(color, min=0.0)
