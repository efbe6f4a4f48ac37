"""Affordance label transfer and its evaluation. Counterpart:
``tpugs/query/affordance.py:51-331``.

Labelled 2D exemplars (labelme JSON with base64 PNG masks or polygons)
pool an encoder's features into a bank; each Gaussian of a lifted field
takes the majority label of its k nearest exemplars (``query/knn.py``);
the labelled scene renders with a palette blended into its DC colour, and
per-class IoU and recall are scored against ground-truth label maps
(``.mat`` files or PNGs). The three 2D-mask -> 3D votes: gradient voting
(``lift/ops.py::accumulate_view`` with the mask as a 1-channel feature
image: B2 with f32 rows and B3), binary voting, and projection voting by
each Gaussian's projected centre.

``imageio`` (PNG masks and exemplar images) and ``cv2`` (polygons, mask
resizes) are imported where they are used.
"""

from __future__ import annotations

import base64
import io
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpugs_torch.core.device import DeviceLike, resolve_device
from tpugs_torch.core.scene import GaussianScene

# 8-class palette (label 0 = background/none)
AFFORDANCE_CLASSES = (
    "none", "grasp", "cut", "scoop", "contain", "pound", "support", "wrap",
)
PALETTE = np.array(
    [
        [0.5, 0.5, 0.5],
        [0.9, 0.1, 0.1],
        [0.1, 0.9, 0.1],
        [0.1, 0.1, 0.9],
        [0.9, 0.9, 0.1],
        [0.9, 0.1, 0.9],
        [0.1, 0.9, 0.9],
        [0.9, 0.5, 0.1],
    ],
    np.float32,
)


@dataclass
class ExemplarBank:
    features: np.ndarray  # (M, D)
    labels: np.ndarray  # (M,) int


def decode_labelme_mask(b64png: str) -> np.ndarray:
    """base64 PNG -> bool mask."""
    import imageio.v2 as imageio

    img = imageio.imread(io.BytesIO(base64.b64decode(b64png)))
    if img.ndim == 3:
        img = img[..., 0]
    return img > 127


def load_exemplars(
    json_dir: str,
    encoder,  # (H, W, 3) -> (H, W, D) feature encoder (DINO)
    image_loader=None,  # name -> (H, W, 3) float image
    patch: int = 14,
    class_names: Sequence[str] = AFFORDANCE_CLASSES,
    device: DeviceLike = "cuda",
) -> ExemplarBank:
    """Labelme exemplars -> a feature/label bank: the encoder runs on each
    exemplar image on ``device``, and each labelled mask's features are
    averaged."""
    dev = resolve_device(device)
    name_to_id = {n: i for i, n in enumerate(class_names)}
    feats: List[np.ndarray] = []
    labels: List[int] = []
    for fn in sorted(os.listdir(json_dir)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(json_dir, fn)) as fh:
            meta = json.load(fh)
        img_name = meta.get("imagePath", fn.replace(".json", ".jpg"))
        if image_loader is not None:
            image = image_loader(img_name)
        else:
            import imageio.v2 as imageio

            image = imageio.imread(os.path.join(json_dir, img_name)).astype(np.float32) / 255.0
        rgb = torch.from_numpy(np.ascontiguousarray(image[..., :3], np.float32)).to(dev)
        with torch.inference_mode():
            fmap = encoder(rgb).float().cpu().numpy()
        for shape in meta.get("shapes", []):
            label = shape.get("label", "none")
            if label not in name_to_id:
                continue
            if "mask" in shape and shape["mask"]:
                mask = decode_labelme_mask(shape["mask"])
            elif "points" in shape:
                mask = _polygon_mask(shape["points"], image.shape[0], image.shape[1])
            else:
                continue
            if mask.shape != fmap.shape[:2]:
                import cv2

                mask = cv2.resize(mask.astype(np.uint8), (fmap.shape[1], fmap.shape[0])) > 0
            if mask.sum() == 0:
                continue
            feats.append(fmap[mask].mean(axis=0))
            labels.append(name_to_id[label])
    if not feats:
        return ExemplarBank(np.zeros((0, 1), np.float32), np.zeros(0, np.int64))
    return ExemplarBank(np.stack(feats).astype(np.float32), np.array(labels, np.int64))


def _polygon_mask(points, h, w) -> np.ndarray:
    import cv2

    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [np.asarray(points, np.int32)], 1)
    return mask > 0


def transfer_affordance(
    gaussian_features: torch.Tensor,  # (N, D) lifted field
    bank: ExemplarBank,
    k: int = 5,
    min_similarity: Optional[float] = None,
) -> np.ndarray:
    """(N,) affordance labels by k-NN majority vote, on the features'
    device; with ``min_similarity``, 0 where the nearest exemplar's cosine
    is below it."""
    from tpugs_torch.query.knn import knn_search, transfer_labels

    dev = gaussian_features.device
    f = gaussian_features / (
        torch.linalg.vector_norm(gaussian_features, dim=-1, keepdim=True) + 1e-8)
    b = bank.features / (np.linalg.norm(bank.features, axis=-1, keepdims=True) + 1e-8)
    b = torch.from_numpy(np.asarray(b, np.float32)).to(dev)
    labels = transfer_labels(
        f, b, torch.from_numpy(bank.labels.astype(np.int64)).to(dev),
        k=min(k, len(bank.labels)), num_classes=len(AFFORDANCE_CLASSES))
    if min_similarity is not None:
        scores, _ = knn_search(f, b, k=1)
        labels = torch.where(scores[:, 0] >= min_similarity, labels, 0)
    return labels.cpu().numpy()


def colorize_by_labels(
    scene: GaussianScene, labels: np.ndarray, blend: float = 0.8
) -> GaussianScene:
    """Blend the palette into the DC colour of every labelled Gaussian;
    higher-order SH zeroed."""
    C0 = 0.28209479177387814  # the literal of tpugs' affordance.py
    dev = scene.means.device
    labels = torch.as_tensor(labels, device=dev)
    colors = scene.sh0[:, 0, :] * C0 + 0.5
    palette = torch.from_numpy(PALETTE).to(dev)
    target = palette[labels.clamp(0, len(PALETTE) - 1)]
    mixed = torch.where((labels > 0)[:, None], (1 - blend) * colors + blend * target, colors)
    return scene.replace(sh0=((mixed - 0.5) / C0)[:, None, :],
                         shN=torch.zeros_like(scene.shN))


def _on(scene: GaussianScene, m) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32).to(scene.means.device)


@torch.inference_mode()
def render_label_masks(
    scene: GaussianScene, labels: np.ndarray, viewmat, K,
    width: int, height: int, threshold: float = 0.5,
) -> np.ndarray:
    """(H, W) int64 predicted label map: the one-hot label colours rendered
    (B4 at D = 8), argmax per pixel, 0 where alpha < ``threshold``."""
    from tpugs_torch.raster.api import plan_render, rasterize_with_plan

    n_classes = len(AFFORDANCE_CLASSES)
    dev = scene.means.device
    labels = torch.as_tensor(labels, device=dev).clamp(0, n_classes - 1)
    onehot = torch.eye(n_classes, dtype=torch.float32, device=dev)[labels]
    vm, Km = _on(scene, viewmat), _on(scene, K)
    plan = plan_render(scene.means, scene.quats, scene.scales, scene.opacities, vm, Km,
                       width, height)
    img, alpha = rasterize_with_plan(scene.means, scene.quats, scene.scales, scene.opacities,
                                     onehot, vm, Km, plan)
    pred = img.argmax(dim=-1)
    pred[alpha < threshold] = 0
    return pred.cpu().numpy()


def load_mat_gt(gt_dir: str) -> List[Tuple[int, np.ndarray]]:
    """The reference's ``*label.mat`` ground truth (keys ``gt_label``, the
    (H, W) class map, and ``gt_type``, "manual" or "automatic"; automatic
    views are skipped), sorted by name and paired by position with the
    name-sorted cameras: [(camera_index, gt_label), ...]."""
    from scipy.io import loadmat

    files = sorted(f for f in os.listdir(gt_dir) if f.endswith("label.mat"))
    out: List[Tuple[int, np.ndarray]] = []
    for i, fname in enumerate(files):
        gt = loadmat(os.path.join(gt_dir, fname))
        gt_type = gt.get("gt_type")
        if gt_type is not None:
            flat = np.asarray(gt_type).ravel()
            if flat.size and str(flat[0]) == "automatic":
                continue
        out.append((i, np.asarray(gt["gt_label"]).astype(np.int64)))
    return out


def resize_nearest(label_map: np.ndarray, height: int, width: int):
    """Nearest-neighbour resize of an integer label map by floor indexing
    (row i takes source row floor(i * h / height))."""
    h, w = label_map.shape[:2]
    if (h, w) == (height, width):
        return label_map
    rows = (np.arange(height) * (h / height)).astype(np.int64)
    cols = (np.arange(width) * (w / width)).astype(np.int64)
    return label_map[rows[:, None], cols[None, :]]


def evaluate_iou(
    pred_masks: Sequence[np.ndarray],  # per-view (H, W) int label maps
    gt_masks: Sequence[np.ndarray],
    n_classes: int = len(AFFORDANCE_CLASSES),
) -> Dict[str, Dict[str, float]]:
    """Per-class IoU and recall over all views, and their means."""
    inter = np.zeros(n_classes)
    union = np.zeros(n_classes)
    gt_count = np.zeros(n_classes)
    for pred, gt in zip(pred_masks, gt_masks):
        for c in range(1, n_classes):
            p = pred == c
            g = gt == c
            inter[c] += np.logical_and(p, g).sum()
            union[c] += np.logical_or(p, g).sum()
            gt_count[c] += g.sum()
    out = {}
    for c in range(1, n_classes):
        if union[c] == 0 and gt_count[c] == 0:
            continue
        out[AFFORDANCE_CLASSES[c]] = {
            "iou": float(inter[c] / union[c]) if union[c] else 0.0,
            "recall": float(inter[c] / gt_count[c]) if gt_count[c] else 0.0,
        }
    ious = [v["iou"] for v in out.values()]
    recalls = [v["recall"] for v in out.values()]
    out["mean"] = {
        "iou": float(np.mean(ious)) if ious else 0.0,
        "recall": float(np.mean(recalls)) if recalls else 0.0,
    }
    return out


# ------------------------------------------------- 2D-mask voting methods


def vote_gradient(
    scene: GaussianScene, viewmat, K, width: int, height: int,
    mask2d: np.ndarray,
) -> np.ndarray:
    """Gradient voting: each Gaussian's blend-weighted mask integral over
    its weight, num / (den + 1e-12), by one fused adjoint pass (B2 with
    f32 rows, B3) on the scene's device."""
    from tpugs_torch.lift.ops import accumulate_view

    m = _on(scene, np.asarray(mask2d, np.float32))[..., None]
    num, den = accumulate_view(scene, _on(scene, viewmat), _on(scene, K), width, height,
                               feat_image=m, device=scene.means.device)
    return (num[:, 0] / (den + 1e-12)).cpu().numpy()


def vote_binary(scene, viewmat, K, width, height, mask2d) -> np.ndarray:
    """Binary voting: 1 where the gradient vote is above 0.5."""
    scores = vote_gradient(scene, viewmat, K, width, height, mask2d)
    return (scores > 0.5).astype(np.float32)


def vote_projection(
    scene, viewmat, K, width: int, height: int, mask2d
) -> np.ndarray:
    """Projection voting: the mask at each visible Gaussian's projected
    centre (coordinates truncated toward zero, then clipped to the image)."""
    from tpugs_torch.raster.projection import ProjectionConfig, project

    with torch.no_grad():
        proj = project(scene.means, scene.quats, scene.scales, scene.opacities,
                       _on(scene, viewmat), _on(scene, K), width, height, ProjectionConfig())
    xy = proj.means2d.cpu().numpy()
    valid = proj.valid.cpu().numpy()
    x = np.clip(xy[:, 0].astype(int), 0, width - 1)
    y = np.clip(xy[:, 1].astype(int), 0, height - 1)
    votes = np.asarray(mask2d)[y, x].astype(np.float32)
    votes[~valid] = 0.0
    return votes
