"""CLI: compressed (16-d) feature back-projection. Counterpart:
``tpugs/apps/backproject_compressed.py``.

Each view's teacher features pass through the trained codec's encoder
(512 -> 16) before lifting, so the per-Gaussian sums are N x 17 in place
of N x 513. On the command line:

    python -m tpugs_torch.apps.backproject_compressed --data-dir DATA \\
        --checkpoint CKPT --results-dir OUT --codec-path CODEC.npz \\
        --data-factor 1 --feature linear:16 [--device cpu]

It saves ``features_<feature>_compressed.npz``.
"""

from __future__ import annotations

import os

from tpugs_torch.query.text import highest_precision


class CompressedEncoder:
    """A 2D encoder followed by the codec's encoder: ``inner(image) @
    codec.encoder``. It is as pixelwise as ``inner``, so the fused lift
    keeps the render's tile layout for pixelwise encoders."""

    def __init__(self, inner, codec):
        self.inner = inner
        self.codec = codec
        self.feature_dim = codec.encoder.shape[1]
        self.pixelwise = getattr(inner, "pixelwise", False)

    def __call__(self, image):
        feats = self.inner(image)
        with highest_precision():
            return feats @ self.codec.encoder


def main(
    data_dir: str = "./data/garden",
    checkpoint: str = "./data/garden/ckpts/ckpt_29999_rank0.pt",
    results_dir: str = "./results/garden",
    codec_path: str = "./results/garden/encoder_decoder.npz",
    format: str = "gsplat",
    data_factor: int = 4,
    feature: str = "lseg",
    skip_prune: bool = False,
    engine: str = "auto",
    device: str = "cuda",
):
    """``engine``: 'pallas' (``backproject_views`` + ``normalize_field``:
    B1/B2/B3, bf16 rows, tile 32), 'eager' (``create_feature_field``, per
    view), or 'auto' = pallas on any device (tpugs picks eager on a CPU).
    Returns the saved (N, D_lat) features."""
    from tpugs_torch.apps.backproject import save_features
    from tpugs_torch.codec.linear import load_codec
    from tpugs_torch.core.device import resolve_device
    from tpugs_torch.encoders import get_encoder
    from tpugs_torch.io.checkpoints import load_checkpoint
    from tpugs_torch.lift.backproject import create_feature_field
    from tpugs_torch.lift.prune import prune_by_gradients, verify_pruning_equivalence

    dev = resolve_device(device)
    os.makedirs(results_dir, exist_ok=True)
    scene, cams, _ = load_checkpoint(checkpoint, data_dir, format, data_factor, dev)
    if not skip_prune:
        pruned = prune_by_gradients(scene, cams, device=dev)
        verify_pruning_equivalence(scene, pruned, cams, device=dev)
        scene = pruned

    codec = load_codec(codec_path, device=dev)
    encoder = CompressedEncoder(get_encoder(feature, device=dev), codec)
    if engine == "auto":
        engine = "pallas"
    if engine == "pallas":
        from tpugs_torch.lift.batch import backproject_views, normalize_field

        num, den = backproject_views(scene, cams.viewmats, cams.Ks, cams.width, cams.height,
                                     encoder, device=dev)
        features = normalize_field(num, den)
    elif engine == "eager":
        features = create_feature_field(scene, cams, encoder, device=dev)
    else:
        raise ValueError(f"unknown engine {engine!r} (expected auto|pallas|eager)")
    return save_features(features, None, results_dir, f"{feature}_compressed")


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
