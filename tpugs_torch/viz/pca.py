"""PCA visualisation of lifted feature fields. Counterpart:
``tpugs/viz/pca.py:29-120`` (``feature_pca``, ``pca_colors``,
``render_pca``).

Two modes:
  * ``gaussian`` — 3-component PCA of the (N, D) features, normalised to
    colours and rendered as each Gaussian's colour;
  * ``frame``    — the full D-channel feature image of each view, each pixel
    projected through the PCA; the first view's percentiles normalise
    every view.

The mean, the covariance and the projections are float64 on the
features' device; the (D, D) ``eigh`` runs on the host in numpy, as in
tpugs, so the components' signs are LAPACK's there too. Percentiles are
``torch.quantile`` (linear, as ``np.percentile``), column by column, so
its 2^24-element input limit binds at 2^24 rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpugs_torch.core.camera import Camera
from tpugs_torch.core.scene import GaussianScene
from tpugs_torch.viz.common import to_uint8
from tpugs_torch.viz.gif import render_colors, save_gif, view_plan


def feature_pca(features, n_components: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the PCA: (mean (D,), components (D, C)), float64 on the
    features' device."""
    x = torch.as_tensor(features).double()
    mean = x.mean(dim=0)
    xc = x - mean
    cov = xc.T @ xc / max(x.shape[0] - 1, 1)
    del xc
    _, eigvecs = np.linalg.eigh(cov.cpu().numpy())
    comps = np.ascontiguousarray(eigvecs[:, ::-1][:, :n_components])
    return mean, torch.from_numpy(comps).to(x.device)


def _percentile(proj: torch.Tensor, q: float) -> torch.Tensor:
    return torch.stack([torch.quantile(proj[:, j], q / 100) for j in range(proj.shape[1])])


def pca_colors(
    features,
    mean: torch.Tensor,
    comps: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    hi: Optional[torch.Tensor] = None,
):
    """Project and min/max-normalise to [0, 1] colours: (colors (M, C),
    lo, hi), float64; pass ``lo``/``hi`` back to share one normalisation."""
    proj = (torch.as_tensor(features).double() - mean) @ comps
    if lo is None:
        lo = _percentile(proj, 1)
        hi = _percentile(proj, 99)
    colors = torch.clamp((proj - lo) / (hi - lo + 1e-9), 0, 1)
    return colors, lo, hi


@torch.inference_mode()
def render_pca(
    scene: GaussianScene,
    features: torch.Tensor,
    cams: Camera,
    output_path: Optional[str] = None,
    mode: str = "gaussian",
    fps: int = 10,
):
    """The PCA-coloured scene over all views: uint8 frames; the GIF where
    ``output_path`` is given."""
    if mode not in ("gaussian", "frame"):
        raise ValueError(f"unknown pca mode {mode!r}")
    mean, comps = feature_pca(features)
    frames = []
    if mode == "gaussian":
        colors = pca_colors(features, mean, comps)[0].float()
        for c in range(cams.num_cameras):
            img, _ = render_colors(scene, cams, c, view_plan(scene, cams, c), colors)
            frames.append(to_uint8(img))
    else:
        lo = hi = None
        for c in range(cams.num_cameras):
            feat_img, _ = render_colors(scene, cams, c, view_plan(scene, cams, c), features)
            H, W, D = feat_img.shape
            cols, lo, hi = pca_colors(feat_img.reshape(-1, D), mean, comps, lo, hi)
            frames.append(to_uint8(cols.reshape(H, W, 3)))
    if output_path is not None:
        save_gif(frames, output_path, fps)
    return frames
