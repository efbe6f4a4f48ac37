"""3DGS scene state. Counterpart: ``tpugs/core/scene.py:37-75``.

Raw (pre-activation) parameterisation as in gsplat checkpoints:
``quats`` (N, 4) wxyz, not necessarily normalised; ``log_scales`` (N, 3);
``logit_opacities`` (N,); ``sh0`` (N, 1, 3) and ``shN`` (N, K, 3) SH
coefficients. Activations (``sigmoid``/``exp``) are applied on access.
The trainer's optional feature field: ``features`` (N, Df) per-Gaussian
latents and ``feature_proj`` (Df, Dout), the shared projection to the
teacher's width; both are None on scenes without features.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    means: torch.Tensor  # (N, 3) float32 world-space centres
    quats: torch.Tensor  # (N, 4) wxyz rotation
    log_scales: torch.Tensor  # (N, 3) log of per-axis stddev
    logit_opacities: torch.Tensor  # (N,)
    sh0: torch.Tensor  # (N, 1, 3)
    shN: torch.Tensor  # (N, K, 3); K may be 0
    features: Optional[torch.Tensor] = None  # (N, Df) feature field
    feature_proj: Optional[torch.Tensor] = None  # (Df, Dout) shared projection

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        k = 1 + self.shN.shape[1]
        return int(round(k**0.5)) - 1

    @property
    def opacities(self) -> torch.Tensor:
        """Activated opacity in (0, 1)."""
        return torch.sigmoid(self.logit_opacities)

    @property
    def scales(self) -> torch.Tensor:
        """Activated per-axis standard deviations."""
        return torch.exp(self.log_scales)

    @property
    def colors_all(self) -> torch.Tensor:
        """(N, 1+K, 3) concatenated SH coefficients."""
        return torch.cat([self.sh0, self.shN], dim=1)

    def to(self, device) -> "GaussianScene":
        return GaussianScene(
            **{
                f.name: None if getattr(self, f.name) is None
                else getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )
