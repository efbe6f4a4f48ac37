"""Build the at-scale synthetic training dataset. Counterpart:
``scripts/make_atscale_dataset.py``.

The reference's canonical trainer workload is Mip-NeRF 360 garden; no
dataset ships with the repository, so the at-scale run uses the same shape
of problem on a synthetic scene: a dense ground-truth 3DGS scene rendered
from an orbit of cameras, with an SfM-like point cloud (points sampled from
the ground truth's means, as COLMAP triangulation would give) for
``init_type="sfm"``. The steps and their order are tpugs': the scene, the
orbit, the cloud (``default_rng(seed + 1)``), the COLMAP model, the renders
(``render_to_gif``), the JPEGs ``images/frame_XXXX.jpg`` and the
ground truth as a gsplat ``ckpt.pt``. The JPEGs are written with ``cv2``
at quality 75 from the RGB frames flipped to ``cv2``'s BGR, which gives
the bytes of ``imageio.imwrite``'s default JPEG. On the command line:

    python -m tpugs_torch.apps.make_atscale_dataset --out /tmp/atscale/data \\
        --n-gaussians 20000 --n-cams 24 --width 480 --height 320 [--device cpu]

``main`` returns the seconds of each piece ("scene", "colmap", "render",
"jpeg", "ckpt") and the rendered frames.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

SH_C0 = 0.28209479177387814
JPEG_QUALITY = 75  # imageio's default: the same bytes as its JPEG writer


def write_jpeg(path: str, frame: np.ndarray) -> None:
    """An RGB uint8 frame as a JPEG (``cv2``'s encoder takes BGR)."""
    import cv2

    if not cv2.imwrite(path, np.ascontiguousarray(frame[..., ::-1]),
                       [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY]):
        raise OSError(f"cv2 could not write {path}")


def main(
    out: str = "/tmp/atscale/data",
    n_gaussians: int = 20_000,
    n_cams: int = 24,
    width: int = 480,
    height: int = 320,
    n_sfm_points: int = 5_000,
    radius: float = 2.5,
    seed: int = 0,
    device: str = "cuda",
):
    """Write the dataset under ``out``; ``device``: where the scene is
    rendered, "cuda" or "cpu"."""
    from tpugs_torch.core.device import resolve_device
    from tpugs_torch.io.checkpoints import save_scene_pt
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene, write_synthetic_colmap
    from tpugs_torch.viz.gif import render_to_gif

    dev = resolve_device(device)
    seconds = {}
    clock = [time.perf_counter()]

    def lap(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    scene = random_scene(n_gaussians, seed=seed, extent=0.9, scale_range=(0.008, 0.05),
                         device=dev)
    cams = orbit_cameras(n_cams, width, height, radius=radius, device=dev)
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    lap("scene")

    # SfM-like sparse cloud: ground-truth centres and their DC colours
    rng = np.random.default_rng(seed + 1)
    idx = rng.choice(n_gaussians, size=min(n_sfm_points, n_gaussians), replace=False)
    pts = scene.means.cpu().numpy()[idx]
    rgb = np.clip(scene.sh0.cpu().numpy()[idx, 0] * SH_C0 + 0.5, 0, 1)
    write_synthetic_colmap(out, cams, points=pts, point_rgbs=(rgb * 255).astype(np.uint8))
    lap("colmap")

    frames = render_to_gif(None, scene, cams, save_frames=False)
    lap("render")
    for i, f in enumerate(frames):
        write_jpeg(os.path.join(out, f"images/frame_{i:04d}.jpg"), f)
    lap("jpeg")
    save_scene_pt(scene, os.path.join(out, "ckpt.pt"))
    lap("ckpt")
    print(f"wrote {out}: {n_cams} cams {width}x{height}, "
          f"{n_gaussians} GT gaussians, {len(pts)} sfm points")
    return {"seconds": seconds, "frames": frames}


if __name__ == "__main__":
    from tpugs_torch.utils.cli import cli

    cli(main)
