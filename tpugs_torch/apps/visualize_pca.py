"""CLI: PCA visualisation of a lifted feature field. Counterpart:
``tpugs/apps/visualize_pca.py``.

    python -m tpugs_torch.apps.visualize_pca --data-dir DATA --checkpoint CKPT \\
        --results-dir OUT --data-factor 1 --feature linear:8 [--device cpu]

writes ``pca_gaussian.gif`` and ``pca_frame.gif`` (``io/images.py``) beside
``features_<feature>.npz``; ``--f3dgs`` takes ``features @ feature_proj``
of a trained feature field instead.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def main(
    data_dir: str = "./data/garden",
    checkpoint: str = "./data/garden/ckpts/ckpt_29999_rank0.pt",
    results_dir: str = "./results/garden",
    format: str = "gsplat",
    data_factor: int = 4,
    feature: str = "lseg",
    f3dgs: bool = False,
    skip_prune: bool = False,
    device: str = "cuda",
):
    """Returns the two frame lists (gaussian mode, frame mode)."""
    from tpugs_torch.core.device import resolve_device
    from tpugs_torch.io.checkpoints import load_checkpoint
    from tpugs_torch.lift.prune import prune_by_gradients, verify_pruning_equivalence
    from tpugs_torch.viz.pca import render_pca

    dev = resolve_device(device)
    scene, cams, _ = load_checkpoint(checkpoint, data_dir, format, data_factor, dev)
    if not skip_prune:
        pruned = prune_by_gradients(scene, cams, device=dev)
        verify_pruning_equivalence(scene, pruned, cams, device=dev)
        scene = pruned

    if f3dgs:
        if scene.features is None or scene.feature_proj is None:
            raise ValueError("--f3dgs needs a checkpoint trained with a feature field")
        features = scene.features @ scene.feature_proj
    else:
        feats = np.load(os.path.join(results_dir, f"features_{feature}.npz"))["features"]
        features = torch.from_numpy(np.asarray(feats, np.float32)).to(dev)

    os.makedirs(results_dir, exist_ok=True)
    frames = [render_pca(scene, features, cams, os.path.join(results_dir, f"pca_{mode}.gif"),
                         mode=mode) for mode in ("gaussian", "frame")]
    print("Saved pca_gaussian.gif / pca_frame.gif to", results_dir)
    return frames


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
