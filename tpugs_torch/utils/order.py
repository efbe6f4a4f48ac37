"""Spatial re-ordering of Gaussian scenes. Counterpart:
``tpugs/utils/order.py``.

The fused pipeline's two wall-bound stages are random ROW gathers (the
pack gather over the param table, the reduce gather over contribution
rows). A Gaussian's tile neighbours are its spatial neighbours, so
sorting the scene by 3D Morton code clusters each tile's gather
indices — where the gathers reward address locality, a one-time
permutation of the checkpoint buys throughput in every view.

The permutation is semantically free: rendering and back-projection
commute with any permutation of the Gaussian axis (up to float
reassociation); per-Gaussian outputs are mapped back with the inverse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpugs_torch.core.scene import GaussianScene


def morton_codes(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """3D Morton (Z-curve) codes of ``points`` (N, 3), uint64."""
    pts = np.asarray(points, np.float64)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    q = ((pts - lo) / np.maximum(hi - lo, 1e-12) * (2**bits - 1)).astype(
        np.uint64
    )

    def spread(v):
        v &= np.uint64((1 << bits) - 1)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x0924924909249249)
        return v

    return (
        spread(q[:, 0])
        | (spread(q[:, 1]) << np.uint64(1))
        | (spread(q[:, 2]) << np.uint64(2))
    )


def morton_permutation(scene: GaussianScene, bits: int = 10) -> np.ndarray:
    """Permutation sorting the scene's Gaussians along a Z-curve."""
    return np.argsort(morton_codes(scene.means.detach().cpu().numpy(), bits),
                      kind="stable")


def permute_scene(scene: GaussianScene, perm: np.ndarray) -> GaussianScene:
    """Apply a Gaussian-axis permutation to every per-Gaussian tensor
    (those whose first axis has N entries), on the scene's device."""
    n = scene.num_gaussians
    idx = torch.as_tensor(np.asarray(perm), dtype=torch.long, device=scene.means.device)

    def take(a):
        if a is not None and a.ndim >= 1 and a.shape[0] == n:
            return a[idx]
        return a

    return GaussianScene(**{f.name: take(getattr(scene, f.name))
                            for f in dataclasses.fields(scene)})


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(np.asarray(perm))
    inv[np.asarray(perm)] = np.arange(len(inv))
    return inv
