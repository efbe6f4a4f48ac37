"""Densification strategies, first part. Counterpart:
``tpugs/train/strategy.py`` (``GradState`` :28-47, ``make_strategy``
:231).

``GradState`` accumulates the screen-space gradient statistic on the
trainer's device. Of the strategies only "none" runs in this slice: the
Default and MCMC ``refine`` (and the trainer's optimizer-state surgery
around it) wait for ROADMAP item 4.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class GradState:
    """Accumulated screen-space gradient statistics: the per-Gaussian sum
    of ||d mean2d|| (NDC units) and the number of frames it was visible."""

    grad2d_sum: torch.Tensor  # (N,) float32
    count: torch.Tensor  # (N,) float32

    @staticmethod
    def zeros(n: int, device="cpu") -> "GradState":
        z = torch.zeros((n,), dtype=torch.float32, device=device)
        return GradState(z, z.clone())

    def accumulate(self, grad2d_norm: torch.Tensor, visible: torch.Tensor) -> None:
        self.grad2d_sum += grad2d_norm
        self.count += visible.to(torch.float32)


def make_strategy(config, scene_scale: float, seed: int = 0):
    """None for ``strategy="none"``; Default and MCMC are not ported yet."""
    if config.strategy in ("default", "mcmc"):
        raise NotImplementedError(
            f"strategy {config.strategy!r} (densification refine) is not ported yet: "
            "ROADMAP item 4; use strategy='none'"
        )
    if config.strategy == "none":
        return None
    raise ValueError(f"unknown strategy {config.strategy!r}")
