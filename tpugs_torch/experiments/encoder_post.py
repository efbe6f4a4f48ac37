"""Where does the LSeg encoder's post step go? The post step takes the
network's (1, 512, 240, 240) output to the render's (840, 1296, 512) bf16
features: a per-pixel L2 norm in float32, then jax.image.resize's bilinear
upsample, then the cast. Two variants compute it:

  antialiased  ``F.interpolate(..., antialias=True)`` on the NCHW features,
               then a transposing cast to (H, W, D): the first version
  plain        the plain bilinear kernel on a channels-last copy, whose
               output is already (H, W, D) in memory, then the cast alone:
               ``LSegEncoder.post`` (``resize`` takes it where no axis
               shrinks; it computes the same triangle filter)

They differ by rounding only. On the card::

    python -m tpugs_torch.experiments.encoder_post

prints each variant's time in turns (antialiased, plain, plain,
antialiased), their largest difference, and the bound: the bytes the step
must move (the bf16 input read once, the bf16 output written once) at
3.35 TB/s.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from tpugs_torch.encoders.lseg import LSegEncoder
from tpugs_torch.utils.profiling import PEAKS_H100

PEAK_BYTES_S = PEAKS_H100["hbm_gbps"] * 1e9  # H100 SXM, NVIDIA data sheet


def post_antialiased(feats: torch.Tensor, size: Tuple[int, int],
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The first version of ``LSegEncoder.post``."""
    f = feats.float()
    f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-8)
    f = F.interpolate(f, size=size, mode="bilinear", align_corners=False, antialias=True)
    return f.permute(0, 2, 3, 1).to(out_dtype, memory_format=torch.contiguous_format)


def variants(size: Tuple[int, int]) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    return {
        "antialiased": lambda f: post_antialiased(f, size),
        "plain": lambda f: LSegEncoder.post(f, size, torch.bfloat16),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from tpugs_torch.utils.timing import time_cuda

    size = (840, 1296)
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.randn((1, 512, 240, 240), device="cuda", generator=gen).to(torch.bfloat16)
    fns = variants(size)
    a, b = fns["antialiased"](feats), fns["plain"](feats)
    diff = float((a.float() - b.float()).abs().max())
    bound_ms = 1e3 * (feats.numel() * 2 + b.numel() * 2) / PEAK_BYTES_S
    print(f"device: {torch.cuda.get_device_name(0)}; (1, 512, 240, 240) bf16 -> "
          f"{tuple(b.shape)} bf16; largest difference {diff:.3e}; bound {bound_ms:.4f} ms "
          f"by bytes", flush=True)
    for name in ("antialiased", "plain", "plain", "antialiased"):
        print(f"{name:12s} -> {time_cuda(lambda: fns[name](feats), args.iters):.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
