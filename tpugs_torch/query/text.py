"""Open-vocabulary 3D segmentation by feature scoring. Counterpart:
``tpugs/query/text.py:20-61`` (``_l2norm``, ``score_features``,
``get_mask3d``, ``get_mask2d``).

Any (P, D) query matrix works: CLIP text embeddings, clicked-pixel
features or exemplar vectors. The N x P score is one float32 product, as
tpugs' einsum at ``Precision.HIGHEST``: ``highest_precision`` keeps TF32
off for it whatever the process has set.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch


@contextlib.contextmanager
def highest_precision():
    """Float32 products on the card in full float32 for the block (XLA's
    ``Precision.HIGHEST``); the caller's TF32 setting comes back after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-12)


def score_features(features: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Cosine scores (N, P) between per-Gaussian features (N, D) and query
    vectors (P, D), float32 on the features' device."""
    f = _l2norm(features.float())
    q = _l2norm(queries.to(f.device, torch.float32))
    with highest_precision():
        return f @ q.T


def get_mask3d(
    features: torch.Tensor,
    pos_queries: torch.Tensor,  # (P+, D)
    neg_queries: torch.Tensor,  # (P-, D)
    threshold: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask = max over the positive scores > max over the negative ones,
    and, with ``threshold``, the score against the first positive query
    above it. Returns (mask, ~mask)."""
    queries = torch.cat([pos_queries.to(features.device, torch.float32),
                         neg_queries.to(features.device, torch.float32)])
    score = score_features(features, queries)
    p = pos_queries.shape[0]
    mask = score[:, :p].amax(dim=1) > score[:, p:].amax(dim=1)
    if threshold is not None:
        mask = mask & (score[:, 0] > threshold)
    return mask, ~mask


def get_mask2d(
    feat_image: torch.Tensor,  # (H, W, D) rendered feature image
    pos_queries: torch.Tensor,
    neg_queries: torch.Tensor,
) -> torch.Tensor:
    """Per-pixel mask (H, W) of a rendered feature image."""
    H, W, D = feat_image.shape
    m, _ = get_mask3d(feat_image.reshape(-1, D), pos_queries, neg_queries)
    return m.reshape(H, W)
