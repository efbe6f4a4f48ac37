"""PNG-grid scene compression (the reference's optional
``gsplat.compression.PngCompression`` eval path). Counterpart:
``tpugs/io/compression.py``; ``imageio`` is imported where a PNG is read
or written, as there.

Scheme: Gaussians are spatially sorted (Morton order over quantized
means — the cheap stand-in for PLAS), every attribute is reshaped to a
square grid and quantized to 16-bit (means) or 8-bit (rest) PNGs with
per-attribute min/max stored in a JSON sidecar. Decompression restores
a render-equivalent scene up to quantization (validated by PSNR in the
tests)."""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from tpugs_torch.convert import scene_from_numpy, scene_to_numpy
from tpugs_torch.core.device import DeviceLike
from tpugs_torch.core.scene import GaussianScene


def morton_order(means: np.ndarray, bits: int = 10) -> np.ndarray:
    """Spatial sort permutation by interleaved-bit Morton code."""
    lo = means.min(axis=0)
    hi = means.max(axis=0)
    q = ((means - lo) / np.maximum(hi - lo, 1e-12) * (2**bits - 1)).astype(
        np.uint64
    )

    def spread(x):
        x &= np.uint64((1 << bits) - 1)
        x = (x | (x << np.uint64(16))) & np.uint64(0x0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x249249249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return np.argsort(code)


def _to_grid(a: np.ndarray, side: int) -> np.ndarray:
    n = a.shape[0]
    flat = a.reshape(n, -1)
    pad = side * side - n
    flat = np.concatenate([flat, np.zeros((pad, flat.shape[1]), a.dtype)])
    return flat.reshape(side, side, -1)


def _quantize(a: np.ndarray, bits: int) -> Tuple[np.ndarray, float, float]:
    lo, hi = float(a.min()), float(a.max())
    scale = (2**bits - 1) / max(hi - lo, 1e-12)
    q = np.round((a - lo) * scale)
    dtype = np.uint16 if bits == 16 else np.uint8
    return q.astype(dtype), lo, hi


def _dequantize(q: np.ndarray, lo: float, hi: float, bits: int) -> np.ndarray:
    return q.astype(np.float32) / (2**bits - 1) * (hi - lo) + lo


_ATTR_BITS = {
    "means": 16,
    "quats": 8,
    "scales": 8,
    "opacities": 8,
    "sh0": 8,
    "shN": 8,
}


def compress_scene(scene: GaussianScene, out_dir: str) -> Dict:
    """Write PNG grids + meta.json; returns the meta dict."""
    import imageio.v2 as imageio

    os.makedirs(out_dir, exist_ok=True)
    n = scene.num_gaussians
    arr = scene_to_numpy(scene)
    order = morton_order(arr["means"])
    side = int(np.ceil(np.sqrt(n)))
    attrs = {
        "means": arr["means"][order],
        "quats": arr["quats"][order],
        "scales": arr["log_scales"][order],
        "opacities": arr["logit_opacities"][order][:, None],
        "sh0": arr["sh0"][order],
        "shN": arr["shN"][order],
    }
    meta = {"n": n, "side": side, "attrs": {}}
    for name, a in attrs.items():
        orig_shape = list(a.shape[1:])
        a = a.reshape(n, -1)
        bits = _ATTR_BITS[name]
        # normalize quats for stable quantization
        if name == "quats":
            a = a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-12)
            sign = np.sign(a[:, :1])
            sign[sign == 0] = 1
            a = a * sign
        q, lo, hi = _quantize(a, bits)
        grid = _to_grid(q, side)
        c = grid.shape[-1]
        meta["attrs"][name] = {
            "bits": bits, "lo": lo, "hi": hi, "channels": c,
            "shape": orig_shape,
        }
        # pack channels into PNGs: 16-bit supports only single-channel
        # (PIL), 8-bit groups of <=4; 2-channel padded to 3.
        group = 1 if bits == 16 else 4
        for gi, g0 in enumerate(range(0, c, group)):
            sub = grid[..., g0 : g0 + group]
            if sub.shape[-1] == 2:  # PNG has no 2-channel mode
                sub = np.concatenate(
                    [sub, np.zeros_like(sub[..., :1])], axis=-1
                )
            imageio.imwrite(
                os.path.join(out_dir, f"{name}_{gi}.png"),
                np.ascontiguousarray(sub.squeeze()),
            )
    with open(os.path.join(out_dir, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return meta


def decompress_scene(out_dir: str, device: DeviceLike = "cuda") -> GaussianScene:
    import imageio.v2 as imageio

    with open(os.path.join(out_dir, "meta.json")) as fh:
        meta = json.load(fh)
    n, side = meta["n"], meta["side"]
    attrs = {}
    for name, info in meta["attrs"].items():
        c = info["channels"]
        group = 1 if info["bits"] == 16 else 4
        cols = []
        for gi, g0 in enumerate(range(0, c, group)):
            img = imageio.imread(os.path.join(out_dir, f"{name}_{gi}.png"))
            if img.ndim == 2:
                img = img[..., None]
            want = min(group, c - g0)
            cols.append(img[..., :want])
        grid = np.concatenate(cols, axis=-1)
        flat = grid.reshape(side * side, -1)[:n]
        a = _dequantize(flat, info["lo"], info["hi"], info["bits"])
        attrs[name] = a.reshape([n] + info["shape"])
    return scene_from_numpy({
        "means": attrs["means"],
        "quats": attrs["quats"],
        "log_scales": attrs["scales"],
        "logit_opacities": attrs["opacities"][:, 0],
        "sh0": attrs["sh0"],
        "shN": attrs["shN"],
    }, device=device)


def compressed_size_bytes(out_dir: str) -> int:
    return sum(
        os.path.getsize(os.path.join(out_dir, f))
        for f in os.listdir(out_dir)
    )
