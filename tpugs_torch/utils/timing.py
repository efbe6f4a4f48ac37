"""Kernel timing on the card by CUDA events. Counterpart of
``tpugs/utils/timing.py::measure`` without its perturbation of inputs and
forced reads, which defeated the TPU transport's result cache and have no
use here."""

from __future__ import annotations

from typing import Callable

import torch


def time_cuda(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after ``warmup``, by
    CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters
