"""CLI: train the 512 -> 16 linear feature codec. Counterpart:
``tpugs/apps/train_codec.py``.

CLIP text embeddings of a label vocabulary (ADE20K-150's
``objectInfo150.csv`` by default, through ``encoders.lseg.encode_text``,
which needs the text tower's checkpoint and BPE file), or a precomputed
``--embeddings-npz`` (key ``embeddings``). On the command line:

    python -m tpugs_torch.apps.train_codec --embeddings-npz EMB.npz \\
        --output OUT/encoder_decoder.npz --steps 2000 [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np


def main(
    output: str = "./results/encoder_decoder.npz",
    labels_csv: str = "./objectInfo150.csv",
    embeddings_npz: str = "",
    clip_ckpt: str = "",
    bpe_path: str = "",
    d_lat: int = 16,
    steps: int = 100_000,
    lr: float = 1e-4,
    device: str = "cuda",
):
    """Trains on ``device`` and saves the codec (keys ``encoder``,
    ``decoder``); returns it."""
    from tpugs_torch.codec.linear import save_codec, train_codec
    from tpugs_torch.core.device import resolve_device

    dev = resolve_device(device)
    if embeddings_npz:
        emb = np.load(embeddings_npz)["embeddings"]
    else:
        if not os.path.exists(labels_csv):
            raise FileNotFoundError(
                f"{labels_csv} not found — download objectInfo150.csv from "
                "CSAILVision/sceneparsing, or pass --embeddings-npz.")
        import csv

        labels = []
        with open(labels_csv) as fh:
            for row in csv.DictReader(fh):
                labels.extend(row["Name"].split(";"))
        from tpugs_torch.encoders import lseg

        emb = lseg.encode_text(labels, ckpt=clip_ckpt or None, bpe_path=bpe_path or None,
                               device=dev).cpu().numpy()

    codec, loss = train_codec(emb, d_lat=d_lat, steps=steps, lr=lr, log_every=1000,
                              device=dev)
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    save_codec(codec, output)
    print(f"Saved codec to {output} (final loss {loss:.6f})")
    return codec


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
