"""Tiny cells for the CPU tests: the real cells' files with the sizes cut
so that the plain twins run them in seconds."""

from __future__ import annotations

import copy

from benchmark import harness

TINY_SCENE = {"width": 72, "height": 40, "n_views": 6, "radius": 3.0,
              "extent": 0.8, "scale_min": 0.02, "scale_max": 0.08}
TINY_VIT = {"image_size": 32, "patch_size": 8, "width": 32, "layers": 4, "heads": 2}
TINY_NET = {"lseg": {"hooks": [0, 1, 2, 3], "features": 8, "out_dim": 12,
                     "layer_channels": [8, 16, 32, 32], "crop_size": 32},
            "dino": {"image_size": 28}}
TINY_VIT_DINO = {"image_size": 28, "patch_size": 14, "width": 32, "layers": 2, "heads": 2}


def tiny_spec(cell_name: str, **traffic) -> dict:
    spec = copy.deepcopy(harness.cell(cell_name))
    cfg = spec["config"]
    cfg["scene"].update(TINY_SCENE)
    cfg["vit"].update(TINY_VIT if cfg["encoder"] == "lseg" else TINY_VIT_DINO)
    cfg.update(TINY_NET[cfg["encoder"]])
    t = spec["workload"]["traffic"]
    t.update({"n_gaussians": 3000, "tile_size": 16, "check_pixels": 64, "check_gaussians": 512,
              "warm_views": [0, 3], "trace_views": [0, 2]})
    t.update(traffic)
    return spec
