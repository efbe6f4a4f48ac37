"""Image <-> tile layout. Counterparts: ``tpugs/raster/adjoint.py:35``
(``image_to_tiles``) and ``tpugs/raster/pallas_tiled.py:1380``
(``tiles_to_image``). Tile t covers pixels
``[ty*ts, (ty+1)*ts) x [tx*ts, (tx+1)*ts)`` with ``t = ty*ntx + tx``;
pixel p of a tile is ``(p // ts, p % ts)``, row-major."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpugs_torch.raster.binning import tile_grid


def image_to_tiles(image: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(H, W, D) -> (n_tiles, ts*ts, D), zero-padded at the edges."""
    H, W, D = image.shape
    ntx, nty = tile_grid(W, H, tile_size)
    ts = tile_size
    img = F.pad(image, (0, 0, 0, ntx * ts - W, 0, nty * ts - H))
    img = img.reshape(nty, ts, ntx, ts, D).permute(0, 2, 1, 3, 4)
    return img.reshape(nty * ntx, ts * ts, D)


def tiles_to_image(
    tiles: torch.Tensor, width: int, height: int, tile_size: int
) -> torch.Tensor:
    """(n_tiles, ts*ts, C) -> (H, W, C)."""
    ntx, nty = tile_grid(width, height, tile_size)
    ts = tile_size
    c = tiles.shape[-1]
    t = tiles.reshape(nty, ntx, ts, ts, c).permute(0, 2, 1, 3, 4)
    return t.reshape(nty * ts, ntx * ts, c)[:height, :width]
