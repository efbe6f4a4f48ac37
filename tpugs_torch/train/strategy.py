"""Densification strategies. Counterpart: ``tpugs/train/strategy.py``
(``GradState`` :28-47, ``_np_quat_rotmat`` :80, ``_split_arrs`` :101,
``DefaultStrategy`` :130, ``MCMCStrategy`` :185, ``make_strategy`` :231).

Masks, gathers and concatenations run as torch ops on the scene's device.
The random draws stay the reference's: numpy draws from the strategy's own
``np.random.Generator(seed)``, in its order (the split offsets
``rng.normal(size=(n, 3))``, two per split Gaussian; MCMC's
``rng.choice(alive, size, p)`` with float32 ``p`` computed on the host), so
a seeded refine gives the same Gaussians in the same rows as tpugs. A
Default refine concatenates as the reference does: kept, then duplicated,
then both split halves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpugs_torch.core.scene import GaussianScene

# Per-Gaussian fields; ``feature_proj`` is shared and passes through.
PER_GAUSSIAN = ("means", "quats", "log_scales", "logit_opacities", "sh0", "shN", "features")


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


def _rows(scene: GaussianScene, take) -> dict:
    return {f: None if getattr(scene, f) is None else getattr(scene, f)[take]
            for f in PER_GAUSSIAN}


def _concat(parts) -> dict:
    return {f: None if parts[0][f] is None else torch.cat([p[f] for p in parts])
            for f in PER_GAUSSIAN}


def _quat_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz -> (N, 3, 3), the reference's ``_np_quat_rotmat``."""
    q = quats / torch.clamp(torch.linalg.vector_norm(quats, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (z * z + x * x),
    ], dim=-1).reshape(-1, 3, 3)


def _split(scene: GaussianScene, mask: torch.Tensor, n: int, rng) -> Optional[dict]:
    """The masked Gaussians, twice: each copy moved by a sample of its own
    Gaussian, scales shrunk by 1.6 (the Inria recipe)."""
    if n == 0:
        return None
    sel = _rows(scene, mask)
    R = _quat_rotmat(sel["quats"])
    scales = torch.exp(sel["log_scales"])
    parts = []
    for _ in range(2):
        draw = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(scales.device)
        eps = draw * scales
        offs = (R * eps[:, None, :]).sum(-1)  # elementwise: no TF32 product
        parts.append({**sel, "means": sel["means"] + offs,
                      "log_scales": sel["log_scales"] - np.float32(np.log(1.6))})
    return _concat(parts)


def _scene(fields: dict, feature_proj) -> GaussianScene:
    return GaussianScene(**fields, feature_proj=feature_proj)


class DefaultStrategy:
    """Duplicate small / split large / prune transparent and huge
    Gaussians (the Inria and gsplat default)."""

    def __init__(self, config, scene_scale: float = 1.0, seed: int = 0):
        self.cfg = config
        self.scene_scale = scene_scale
        self.rng = np.random.default_rng(seed)

    def masks(self, scene: GaussianScene, state: GradState) -> dict:
        """The refine's decisions: "keep" (neither pruned nor split),
        "dupli" (kept, high gradient, small), "split" (high gradient,
        large) and "prune" (transparent or huge), (N,) bool each."""
        cfg = self.cfg
        avg_grad = state.grad2d_sum / torch.clamp(state.count, min=1.0)
        is_grad_high = avg_grad > cfg.grow_grad2d
        scales = torch.exp(scene.log_scales).amax(dim=1)
        is_small = scales <= cfg.grow_scale3d * self.scene_scale
        is_split = is_grad_high & ~is_small
        opac = 1.0 / (1.0 + torch.exp(-scene.logit_opacities))  # the reference's sigmoid
        is_prune = (opac < cfg.prune_opa) | (scales > cfg.prune_scale3d * self.scene_scale)
        keep = ~(is_prune | is_split)
        return {"keep": keep, "dupli": is_grad_high & is_small & keep, "split": is_split,
                "prune": is_prune}

    def refine(self, scene: GaussianScene,
               state: GradState) -> Tuple[GaussianScene, GradState, dict]:
        m = self.masks(scene, state)
        n_dupli, n_split, n_prune = (int(m[k].sum()) for k in ("dupli", "split", "prune"))
        parts = [_rows(scene, m["keep"])]
        if n_dupli:
            parts.append(_rows(scene, m["dupli"]))
        split = _split(scene, m["split"], n_split, self.rng)
        if split is not None:
            parts.append(split)
        new_scene = _scene(_concat(parts) if len(parts) > 1 else parts[0], scene.feature_proj)
        info = {"duplicated": n_dupli, "split": n_split, "pruned": n_prune,
                "num_gaussians": new_scene.num_gaussians}
        return new_scene, GradState.zeros(new_scene.num_gaussians, scene.means.device), info

    def reset_opacities(self, scene: GaussianScene, value: float = 0.01) -> GaussianScene:
        """Clamp every opacity to at most ``value`` (every ``reset_every``)."""
        cap = float(np.log(value / (1 - value)))
        return scene.replace(logit_opacities=torch.clamp(scene.logit_opacities, max=cap))


class MCMCStrategy:
    """Stochastic relocation (gsplat MCMC): dead Gaussians take the rows of
    live ones drawn by opacity, so N stays constant."""

    def __init__(self, config, scene_scale: float = 1.0, seed: int = 0):
        self.cfg = config
        self.rng = np.random.default_rng(seed)
        self.scene_scale = scene_scale

    def refine(self, scene: GaussianScene,
               state: GradState) -> Tuple[GaussianScene, GradState, dict]:
        opac = torch.sigmoid(scene.logit_opacities)
        dead = opac < self.cfg.prune_opa
        n_dead = int(dead.sum())
        if n_dead == 0:
            return scene, state, {"relocated": 0, "num_gaussians": scene.num_gaussians}
        opac_host = opac.cpu().numpy()
        alive_idx = np.where(~dead.cpu().numpy())[0]
        probs = opac_host[alive_idx] / opac_host[alive_idx].sum()
        targets = torch.from_numpy(self.rng.choice(alive_idx, size=n_dead, p=probs)).to(
            scene.means.device)

        def reassign(a):
            out = a.clone()
            out[dead] = a[targets]
            return out

        fields = {f: None if getattr(scene, f) is None else reassign(getattr(scene, f))
                  for f in PER_GAUSSIAN}
        return (_scene(fields, scene.feature_proj),
                GradState.zeros(scene.num_gaussians, scene.means.device),
                {"relocated": n_dead, "num_gaussians": scene.num_gaussians})

    def reset_opacities(self, scene: GaussianScene, value: float = 0.01) -> GaussianScene:
        return scene


def make_strategy(config, scene_scale: float, seed: int = 0):
    if config.strategy == "default":
        return DefaultStrategy(config, scene_scale, seed)
    if config.strategy == "mcmc":
        return MCMCStrategy(config, scene_scale, seed)
    if config.strategy == "none":
        return None
    raise ValueError(f"unknown strategy {config.strategy!r}")
