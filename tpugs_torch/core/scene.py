"""3DGS scene state. Counterpart: ``tpugs/core/scene.py:37-137`` (with
``pad_count``).

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

    def replace(self, **kw) -> "GaussianScene":
        return dataclasses.replace(self, **kw)

    def select(self, mask_or_idx) -> "GaussianScene":
        """Every per-Gaussian tensor indexed by a bool mask or an index
        tensor (N,), on the scene's device; ``feature_proj`` is shared."""
        take = torch.as_tensor(mask_or_idx, device=self.means.device)
        return GaussianScene(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name) if f.name == "feature_proj"
            else getattr(self, f.name)[take]
            for f in dataclasses.fields(self)
        })

    def pad_to(self, n_pad: int) -> "GaussianScene":
        """Pad with transparent Gaussians up to ``n_pad``: opacity
        sigmoid(-30), log-scale -10, identity rotation, zero colour. They
        never contribute."""
        n = self.num_gaussians
        if n_pad < n:
            raise ValueError(f"pad_to({n_pad}) smaller than N={n}")
        extra = n_pad - n
        if extra == 0:
            return self

        def pad(a, fill=0.0):
            if a is None:
                return None
            return torch.cat([a, a.new_full((extra,) + tuple(a.shape[1:]), fill)])

        quats = torch.cat([self.quats, self.quats.new_tensor([[1.0, 0, 0, 0]]).expand(extra, 4)])
        return GaussianScene(
            means=pad(self.means), quats=quats, log_scales=pad(self.log_scales, -10.0),
            logit_opacities=pad(self.logit_opacities, -30.0), sh0=pad(self.sh0),
            shN=pad(self.shN), features=pad(self.features), feature_proj=self.feature_proj,
        )

    def to(self, device) -> "GaussianScene":
        return GaussianScene(
            **{
                f.name: None if getattr(self, f.name) is None
                else getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


def pad_count(n: int, multiple: int = 256) -> int:
    """Round N up to a multiple (the trainer's capacity after a refine)."""
    return ((n + multiple - 1) // multiple) * multiple
