"""Roundings for the controls: the reference computed one precision below
the one a configuration states (bfloat16 -> fp8 e4m3 with a per-tensor
scale; float32 -> bfloat16)."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 at a per-tensor scale, back in float32."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def identity(x: torch.Tensor) -> torch.Tensor:
    return x.float()


# precision stated -> the rounding of the control, one step below it
BELOW = {"bfloat16": fp8, "float16": fp8, "float32": bf16}


class exact_float32:
    """Float32 products without TF32 inside the block (the reference's
    precision); the program's own settings are restored after it."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
