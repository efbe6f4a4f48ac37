"""CLI: lift 2D features onto per-Gaussian vectors. Counterpart:
``tpugs/apps/backproject.py``.

Load the checkpoint and the COLMAP model -> prune by blend weights ->
verify render equivalence -> back-project features -> save
``features_<name>.npz``. On the command line:

    python -m tpugs_torch.apps.backproject --data-dir DATA --checkpoint CKPT \\
        --results-dir OUT --data-factor 1 --feature linear:8 [--device cpu]

Encoders: ``grayscale`` / ``linear[:D]`` run out of the box; ``lseg`` /
``dino`` load their weights from ``--encoder-ckpt FILE`` (a lang-seg
``.ckpt`` or a DINOv2 state dict) and run with random weights, with a
warning, without one.
"""

from __future__ import annotations

import os

import numpy as np


def main(
    data_dir: str = "./data/garden",
    checkpoint: str = "./data/garden/ckpts/ckpt_29999_rank0.pt",
    results_dir: str = "./results/garden",
    format: str = "gsplat",
    data_factor: int = 4,
    feature: str = "lseg",
    encoder_ckpt: str = "",
    skip_prune: bool = False,
    batch: bool = True,
    engine: str = "auto",
    strict_sizes: bool = False,
    morton: bool = False,
    device: str = "cuda",
):
    """``engine``: 'pallas' (``backproject_views`` + ``normalize_field``:
    B1/B2/B3 with early exit, bf16 rows, tile 32), 'scan'
    (``create_feature_field_batch``: no early exit, f32 rows), 'eager'
    (``create_feature_field``, per view), or 'auto' = pallas on any device
    (tpugs picks scan on a CPU). ``--no-batch`` is an alias for
    engine=eager. ``strict_sizes`` is accepted for tpugs' flag set; the
    port's plans are exact and have no size buckets to overflow, so it
    prints that there is nothing to audit and changes no result. ``morton``:
    Z-curve-sort the scene before lifting; the features are unpermuted
    before saving. ``encoder_ckpt``: the ViT encoders' checkpoint ("" for
    random weights). ``device``: where everything runs, "cuda" or "cpu"."""
    from tpugs_torch.core.device import resolve_device
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.io.checkpoints import load_checkpoint
    from tpugs_torch.lift.backproject import create_feature_field
    from tpugs_torch.lift.prune import prune_by_gradients, verify_pruning_equivalence

    dev = resolve_device(device)
    if strict_sizes:
        print("strict_sizes: the plans are exact and have no size buckets; nothing to audit")
    os.makedirs(results_dir, exist_ok=True)
    scene, cams, _ = load_checkpoint(checkpoint, data_dir, format, data_factor, dev)

    if not skip_prune:
        pruned = prune_by_gradients(scene, cams, device=dev)
        verify_pruning_equivalence(scene, pruned, cams, device=dev)
        scene = pruned

    encoder = get_encoder(feature, encoder_ckpt or None, device=dev)

    inv_perm = None
    if morton:
        from tpugs_torch.utils.order import (
            inverse_permutation,
            morton_permutation,
            permute_scene,
        )

        perm = morton_permutation(scene)
        inv_perm = inverse_permutation(perm)
        scene = permute_scene(scene, perm)

    if engine == "auto":
        engine = "pallas"
    if not batch:
        engine = "eager"

    if engine == "pallas":
        from tpugs_torch.lift.batch import backproject_views, normalize_field

        num, den = backproject_views(scene, cams.viewmats, cams.Ks, cams.width, cams.height,
                                     encoder, device=dev)
        features = normalize_field(num, den)
    elif engine == "scan":
        from tpugs_torch.lift.batch import create_feature_field_batch

        features = create_feature_field_batch(scene, cams.viewmats, cams.Ks, cams.width,
                                              cams.height, encoder, device=dev)
    elif engine == "eager":
        features = create_feature_field(scene, cams, encoder, device=dev)
    else:
        raise ValueError(f"unknown engine {engine!r} (expected auto|pallas|scan|eager)")

    return save_features(features, inv_perm, results_dir, feature)


def save_features(features, inv_perm, results_dir: str, feature: str) -> np.ndarray:
    """Copy ``features`` to the host, undo ``inv_perm`` (or None) and write
    ``features_<feature>.npz`` with the key ``features``."""
    features = features.cpu().numpy()
    if inv_perm is not None:
        features = features[inv_perm]
    out = os.path.join(results_dir, f"features_{feature}.npz")
    np.savez(out, features=features)
    print("Saved", out, features.shape)
    return features


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
