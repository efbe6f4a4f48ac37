"""CLI: affordance transfer. Counterpart: ``tpugs/apps/affordance.py``.

Lift an encoder's features (or load ``features_<encoder>.npz``) -> pool
the labelled exemplars into a bank -> k-NN label transfer -> the coloured
render (``affordance.gif``) and ``affordance_labels.npz`` -> with
``--gt-dir``, per-class IoU and recall against ``*label.mat`` files or
``frame_XXXX.png`` label maps (``affordance_eval.json``). On the command
line:

    python -m tpugs_torch.apps.affordance --data-dir DATA --checkpoint CKPT \\
        --results-dir OUT --exemplar-dir EXEMPLARS --encoder-name linear:8 \\
        [--gt-dir GT] [--device cpu]
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


def main(
    data_dir: str = "./data/scene",
    checkpoint: str = "./data/scene/ckpts/ckpt.pt",
    results_dir: str = "./results/scene",
    exemplar_dir: str = "./data/affordance_exemplars",
    gt_dir: str = "",
    format: str = "gsplat",
    data_factor: int = 1,
    encoder_name: str = "dino",
    encoder_ckpt: str = "",
    knn: int = 5,
    skip_prune: bool = False,
    device: str = "cuda",
):
    """Returns (labels (N,), the metrics dict or None)."""
    from tpugs_torch.core.device import resolve_device
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.io.checkpoints import load_checkpoint
    from tpugs_torch.lift.backproject import create_feature_field
    from tpugs_torch.lift.prune import prune_by_gradients
    from tpugs_torch.query.affordance import (
        colorize_by_labels,
        evaluate_iou,
        load_exemplars,
        load_mat_gt,
        render_label_masks,
        resize_nearest,
        transfer_affordance,
    )
    from tpugs_torch.viz.gif import render_to_gif

    dev = resolve_device(device)
    os.makedirs(results_dir, exist_ok=True)
    scene, cams, _ = load_checkpoint(checkpoint, data_dir, format, data_factor, dev)
    if not skip_prune:
        scene = prune_by_gradients(scene, cams, device=dev)

    encoder = get_encoder(encoder_name, encoder_ckpt or None, device=dev)
    feat_path = os.path.join(results_dir, f"features_{encoder_name}.npz")
    if os.path.exists(feat_path):
        features = torch.from_numpy(np.asarray(np.load(feat_path)["features"], np.float32)).to(dev)
    else:
        features = create_feature_field(scene, cams, encoder, device=dev)
        np.savez(feat_path, features=features.cpu().numpy())

    bank = load_exemplars(exemplar_dir, encoder, device=dev)
    print(f"exemplar bank: {len(bank.labels)} patches")
    t0 = time.time()
    labels = transfer_affordance(features, bank, k=knn)
    print("kNN transfer:", time.time() - t0, "s")

    colored = colorize_by_labels(scene, labels)
    render_to_gif(os.path.join(results_dir, "affordance.gif"), colored, cams)
    np.savez(os.path.join(results_dir, "affordance_labels.npz"), labels=labels)

    if not gt_dir:
        return labels, None

    def predict(c):
        return render_label_masks(scene, labels, cams.viewmats[c], cams.Ks[c], cams.width,
                                  cams.height)

    preds, gts = [], []
    if any(f.endswith("label.mat") for f in os.listdir(gt_dir)):
        # per-view *label.mat files, sorted and paired by position with the cameras
        for c, gt_label in load_mat_gt(gt_dir):
            if c >= cams.num_cameras:
                break
            preds.append(resize_nearest(predict(c), *gt_label.shape[:2]))
            gts.append(gt_label)
    else:
        from tpugs_torch.io.images import read_image

        for c in range(cams.num_cameras):
            gt_path = os.path.join(gt_dir, f"frame_{c:04d}.png")
            if not os.path.exists(gt_path):
                continue
            gts.append(read_image(gt_path))
            preds.append(predict(c))
    metrics = evaluate_iou(preds, gts)
    print(json.dumps(metrics, indent=2))
    with open(os.path.join(results_dir, "affordance_eval.json"), "w") as fh:
        json.dump(metrics, fh)
    return labels, metrics


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
