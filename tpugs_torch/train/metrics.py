"""Image quality metrics: PSNR and windowed SSIM. Counterpart:
``tpugs/train/metrics.py`` (``psnr`` :18, ``ssim`` :30, ``ssim_loss`` :73).

SSIM uses the 11-tap Gaussian window (sigma 1.5) as a grouped ``conv2d``
with valid padding, in full f32: ``sigma = filt(x*x) - mu^2`` loses its
significance at TF32's 10-bit mantissa, so the convolution runs with
cuDNN's TF32 switched off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(
    pred: torch.Tensor,  # (H, W, C) in [0, 1]
    target: torch.Tensor,
    max_val: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM over the valid window positions and channels."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    channels = pred.shape[-1]
    win = _gaussian_window(window_size, sigma, pred.device)
    weight = win.expand(channels, 1, window_size, window_size).contiguous()

    def filt(x):  # (H, W, C) -> per-channel valid convolution (H', W', C)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            out = F.conv2d(x.permute(2, 0, 1)[None], weight, groups=channels)
        return out[0].permute(1, 2, 0)

    mu_p = filt(pred)
    mu_t = filt(target)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sigma_p = filt(pred * pred) - mu_pp
    sigma_t = filt(target * target) - mu_tt
    sigma_pt = filt(pred * target) - mu_pt
    ssim_map = ((2 * mu_pt + c1) * (2 * sigma_pt + c2)) / (
        (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2)
    )
    return torch.mean(ssim_map)


def ssim_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - SSIM, differentiable (the trainer's loss term)."""
    return 1.0 - ssim(pred, target)
