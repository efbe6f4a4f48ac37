"""Exact inner-product k-NN and label transfer. Counterpart:
``tpugs/query/knn.py:20-46``.

A float32 product (TF32 off) feeds a stable descending sort, cut at k.
Tie rule: the port keeps ``jax.lax.top_k``'s, where the lower bank index
wins among equal scores, both inside the k and at its edge; the stable
sort gives exactly that, where ``torch.topk`` promises no order among
ties on the card. (A zero feature row ties with the whole bank: it votes
with bank rows 0..k-1, as in tpugs.)
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpugs_torch.query.text import highest_precision


def knn_search(
    queries: torch.Tensor,  # (Q, D)
    bank: torch.Tensor,  # (M, D)
    k: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact inner-product top-k: (scores (Q, k), idx (Q, k))."""
    bank = bank.to(queries.device, torch.float32)
    with highest_precision():
        sims = queries.float() @ bank.T
    scores, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return scores[:, :k], idx[:, :k]


def transfer_labels(
    queries: torch.Tensor,  # (Q, D)
    bank: torch.Tensor,  # (M, D)
    bank_labels: torch.Tensor,  # (M,) int
    k: int = 5,
    num_classes: int = 8,
) -> torch.Tensor:
    """k-NN majority vote: (Q,) int64 labels. Votes are counted per class
    (a label outside [0, num_classes) counts for none, as ``jax.nn.one_hot``
    has it) and the first class with the most votes wins."""
    _, idx = knn_search(queries, bank, k)
    votes = bank_labels.to(idx.device)[idx]  # (Q, k)
    classes = torch.arange(num_classes, device=idx.device)
    counts = (votes[..., None] == classes).float().sum(dim=1)  # (Q, C)
    return counts.argmax(dim=-1)
