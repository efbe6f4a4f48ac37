"""CLI: dataset downloader. Counterpart: ``tpugs/apps/download_dataset.py``.

Fetches and unzips the Mip-NeRF 360 captures with ``wget`` and ``unzip``.
It needs network access; where there is none it raises and says where to
place the extracted scenes. Runs on the host only::

    python -m tpugs_torch.apps.download_dataset --save-dir ./data \\
        --dataset mipnerf360
"""

from __future__ import annotations

import os
import subprocess

DATASETS = {
    "mipnerf360": "http://storage.googleapis.com/gresearch/refraw360/360_v2.zip",
    "mipnerf360_extra": (
        "https://storage.googleapis.com/gresearch/refraw360/360_extra_scenes.zip"
    ),
}


def main(save_dir: str = "./data", dataset: str = "mipnerf360"):
    if dataset not in DATASETS:
        raise ValueError(f"unknown dataset {dataset!r}; options: {list(DATASETS)}")
    url = DATASETS[dataset]
    os.makedirs(save_dir, exist_ok=True)
    zip_path = os.path.join(save_dir, os.path.basename(url))
    try:
        subprocess.run(["wget", "-c", url, "-O", zip_path], check=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"download failed ({e}); this machine may have no network access: "
            f"place the extracted dataset under {save_dir}/<scene>/ by hand."
        ) from e
    subprocess.run(["unzip", "-o", zip_path, "-d", save_dir], check=True)
    print("Extracted to", save_dir)


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
