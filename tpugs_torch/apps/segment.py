"""CLI: open-vocabulary 3D segmentation, scene edits and GIF outputs.
Counterpart: ``tpugs/apps/segment.py``.

Load the checkpoint and the COLMAP model -> prune and verify -> load the
lifted features -> a 3D mask from the queries -> the mask-overlay,
extracted and deleted GIFs -> optionally the edited checkpoints. On the
command line:

    python -m tpugs_torch.apps.segment --data-dir DATA --checkpoint CKPT \\
        --results-dir OUT --data-factor 1 --feature linear:8 \\
        --pos-idx 0,1 --neg-idx 5,6 [--device cpu]

Queries are text prompts through the CLIP text tower
(``encoders.lseg.encode_text``, which needs its checkpoint and BPE file)
or, with ``--pos-idx`` / ``--neg-idx``, the features of exemplar
Gaussians. ``--compressed`` scores a 16-d field with the queries projected
through the codec's encoder; ``--f3dgs`` scores ``features @
feature_proj`` of a trained feature field. GIFs and PNG frames are
written by ``io/images.py``.
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
    prompt: str = "Table",
    neg_prompt: str = "Vase;Other",
    pos_idx: str = "",
    neg_idx: str = "",
    data_factor: int = 4,
    feature: str = "lseg",
    f3dgs: bool = False,
    compressed: bool = False,
    codec_path: str = "./results/encoder_decoder.npz",
    export_checkpoint: bool = False,
    skip_prune: bool = False,
    device: str = "cuda",
):
    """Returns the (N,) bool mask on ``device`` and prints ``mask: K/N``.
    ``neg_idx`` empty: the negative queries are the positive ones negated."""
    from tpugs_torch.core.device import resolve_device
    from tpugs_torch.encoders import lseg
    from tpugs_torch.io.checkpoints import load_checkpoint, save_checkpoint
    from tpugs_torch.lift.prune import prune_by_gradients, verify_pruning_equivalence
    from tpugs_torch.query.masks import apply_mask3d
    from tpugs_torch.query.text import get_mask3d
    from tpugs_torch.viz.gif import render_mask_2d_to_gif, render_to_gif

    dev = resolve_device(device)
    os.makedirs(results_dir, exist_ok=True)
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
        suffix = "_compressed" if compressed else ""
        feats = np.load(os.path.join(results_dir, f"features_{feature}{suffix}.npz"))["features"]
        features = torch.from_numpy(np.asarray(feats, np.float32)).to(dev)

    codec = None
    if compressed:
        # text queries live in the 512-d CLIP space: project them through
        # the codec's encoder (score_features renormalises)
        from tpugs_torch.codec.linear import load_codec

        codec = load_codec(codec_path, device=dev)
        if features.shape[-1] != codec.encoder.shape[-1]:
            raise ValueError(
                f"compressed features are {features.shape[-1]}-d but the codec at "
                f"{codec_path} produces {codec.encoder.shape[-1]}-d latents")

    if pos_idx:
        pos_q = features[[int(i) for i in pos_idx.split(",")]]
        neg_q = features[[int(i) for i in neg_idx.split(",")]] if neg_idx else -pos_q
    else:
        pos_q = lseg.encode_text(prompt.split(";"), device=dev)
        neg_q = lseg.encode_text(neg_prompt.split(";"), device=dev)
        if codec is not None:
            pos_q = codec.compress(pos_q)
            neg_q = codec.compress(neg_q)

    mask3d, mask3d_inv = get_mask3d(features, pos_q, neg_q)
    extracted, deleted, _ = apply_mask3d(scene, mask3d, mask3d_inv)

    render_mask_2d_to_gif(scene, features, pos_q, neg_q, cams,
                          os.path.join(results_dir, "mask2d.gif"))
    render_to_gif(os.path.join(results_dir, "extracted.gif"), extracted, cams,
                  use_checkerboard_background=True)
    render_to_gif(os.path.join(results_dir, "deleted.gif"), deleted, cams)

    if export_checkpoint:
        save_checkpoint(extracted, os.path.join(results_dir, "extracted.pt"))
        save_checkpoint(deleted, os.path.join(results_dir, "deleted.pt"))
    print(f"mask: {int(mask3d.sum())}/{scene.num_gaussians} Gaussians selected")
    return mask3d


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
