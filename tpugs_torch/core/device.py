"""Device selection for the port's public entry points (no counterpart in
``tpugs``, where JAX picks the platform).

Entry points default to ``device="cuda"``. Asking for CUDA on a machine
without it raises: the port never carries on quietly on the CPU. The tests
pass ``device="cpu"`` explicitly, which selects the kernels' plain twins.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
