"""Plain feature back-projection of a capture (the lift of
``apps/backproject.py``) for chosen Gaussians: each view rendered front to
back as ``raster.py`` composites it, the encoder run on the render, and
over every view the blend-weighted sums of the pixel features (``num``)
and of the weights (``den``) of the Gaussians ``rows``, over the pixels
inside the image; then the field, ``num / den`` normalised per row. Also
the counts of work that the benchmark's rooflines divide: pairs up to each
pixel's own exit.

A ``Variant`` is an encoder with its roundings: ``round_rows`` rounds the
contribution rows (the weights, the features and each (tile, Gaussian)
row) and ``round_sums`` each view's sums, their running total and the
field's arithmetic. The float32 reference rounds nothing; the control
rounds each one precision below the configuration's
(``precision.BELOW``). The variants share one walk of each view: the
render and the chosen Gaussians' weights do not depend on them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from benchmark.reference import raster
from benchmark.reference.precision import identity

TILE_CHUNK = 128  # tiles whose pair rows are formed in one product


@dataclasses.dataclass
class Variant:
    encode: Callable[[torch.Tensor], torch.Tensor]
    round_rows: Callable[[torch.Tensor], torch.Tensor] = identity
    round_sums: Callable[[torch.Tensor], torch.Tensor] = identity


@dataclasses.dataclass
class Hits:
    """The pairs of the chosen Gaussians in one view: each pair's slot in
    ``rows``, its tile and its weights (P,) at the tile's pixels (zero
    outside the image)."""

    slot: torch.Tensor
    tile: torch.Tensor
    w: torch.Tensor


def render_and_hits(scene: dict, viewmat, K, width: int, height: int, ts: int,
                    trans_eps: float, degree: int, slot: torch.Tensor):
    """One walk of a view: its (H, W, 3) render, its tile lists and the
    ``Hits`` of the Gaussians whose ``slot`` is not negative."""
    proj = raster.project_scene(scene, viewmat, K, width, height)
    tiles = raster.tile_lists(proj, width, height, ts)
    colors = raster.scene_colors(scene, viewmat, degree)
    out = torch.zeros((tiles.n_tiles, ts * ts, 3), dtype=torch.float32, device=colors.device)
    found: List[tuple] = []

    def visit(st: raster.Step) -> None:
        out.index_add_(0, st.active, torch.bmm(st.w, colors[st.gid]))
        pos = torch.where(st.lane, slot[st.gid], torch.full_like(st.gid, -1))
        k, b = torch.nonzero(pos >= 0, as_tuple=True)
        if k.numel():
            found.append((pos[k, b], st.active[k], st.w[k, :, b] * st.inside[k]))

    raster.walk(proj, tiles, trans_eps, visit)
    dev = colors.device
    hits = Hits(*(torch.cat([f[i] for f in found]) if found else empty
                  for i, empty in enumerate((torch.zeros(0, dtype=torch.int64, device=dev),
                                             torch.zeros(0, dtype=torch.int64, device=dev),
                                             torch.zeros((0, ts * ts), device=dev)))))
    return raster.tiles_image(out, tiles), tiles, hits


def pair_sums(hits: Hits, feats: torch.Tensor, n_rows: int, rnd=identity) -> torch.Tensor:
    """(n_rows, D + 1): per chosen Gaussian, the sum over its pairs of the
    (tile, Gaussian) row ``w . [features, 1]`` over the tile's pixels;
    ``feats`` (n_tiles, P, D)."""
    D = feats.shape[-1]
    acc = torch.zeros((n_rows, D + 1), dtype=torch.float32, device=feats.device)
    if hits.slot.numel() == 0:
        return acc
    order = torch.argsort(hits.tile, stable=True)
    tile, slot, w = hits.tile[order], hits.slot[order], rnd(hits.w[order])
    tiles, counts = torch.unique_consecutive(tile, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    at = torch.repeat_interleave(torch.arange(tiles.shape[0], device=tile.device), counts)
    j = torch.arange(tile.shape[0], device=tile.device) - start[at]
    W = torch.zeros((tiles.shape[0], int(counts.max()), w.shape[1]), device=w.device)
    W[at, j] = w
    feats = rnd(feats)
    for c0 in range(0, tiles.shape[0], TILE_CHUNK):
        sel = (at >= c0) & (at < c0 + TILE_CHUNK)
        f = feats[tiles[c0:c0 + TILE_CHUNK]]
        f = torch.cat([f, torch.ones_like(f[..., :1])], -1)
        rows = rnd(torch.bmm(W[c0:c0 + TILE_CHUNK], f))
        acc.index_add_(0, slot[sel], rows[at[sel] - c0, j[sel]])
    return acc


def capture(scene: dict, viewmats, Ks, width: int, height: int, ts: int, trans_eps: float,
            degree: int, rows: torch.Tensor, pixels: torch.Tensor,
            variants: List[Variant]) -> List[Dict[str, torch.Tensor]]:
    """Every view of ``viewmats``, ``Ks`` lifted once for each variant: its
    ``features`` (views, len(pixels), D) at ``pixels`` of each view's
    encoder output, and ``num`` (R, D), ``den`` (R,) and ``field`` (R, D)
    of the Gaussians ``rows`` (R,)."""
    n = scene["means"].shape[0]
    dev = scene["means"].device
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slot[rows] = torch.arange(rows.shape[0], device=dev)
    kept = [{"features": [], "acc": None} for _ in variants]
    with torch.no_grad():
        for c in range(viewmats.shape[0]):
            image, tiles, hits = render_and_hits(scene, viewmats[c], Ks[c], width, height, ts,
                                                 trans_eps, degree, slot)
            for var, k in zip(variants, kept):
                feats = var.encode(image)
                k["features"].append(feats.reshape(-1, feats.shape[-1])[pixels])
                acc = var.round_sums(pair_sums(hits, raster.image_tiles(feats, tiles),
                                               rows.shape[0], var.round_rows))
                k["acc"] = acc if k["acc"] is None else var.round_sums(k["acc"] + acc)
                del feats
            del hits
    out = []
    for var, k in zip(variants, kept):
        num, den = k["acc"][:, :-1], k["acc"][:, -1]
        out.append({"features": torch.stack(k["features"]), "num": num, "den": den,
                    "field": normalize(num, den, var.round_sums)})
    return out


def view_counts(scene: dict, viewmat, K, width: int, height: int, ts: int,
                trans_eps: float) -> Dict[str, int]:
    """The work one view needs, by pixels inside the image and each pair's
    transmittance before it: ``nonzero`` pairs (alpha at or above the clip)
    and ``weighted`` pairs (a nonzero weight) up to each pixel's own exit
    (T before the pair above ``trans_eps``), ``isects`` (tile, Gaussian)
    pairs with a weighted pixel at tile ``ts``, the ``gaussians`` with a
    weighted pixel, and the ``pixels`` of the image."""
    with torch.no_grad():
        proj = raster.project_scene(scene, viewmat, K, width, height)
        tiles = raster.tile_lists(proj, width, height, ts)
        counts = torch.zeros(3, dtype=torch.int64, device=proj["xy"].device)
        seen = torch.zeros(scene["means"].shape[0], dtype=torch.bool, device=proj["xy"].device)

        def visit(st: raster.Step) -> None:
            alive = (st.t_before > trans_eps) & st.inside[..., None]
            nz = alive & (st.alpha > 0)
            wt = nz & (st.w > 0)
            counts[0] += nz.sum()
            counts[1] += wt.sum()
            hit = wt.any(dim=1) & st.lane
            counts[2] += hit.sum()
            seen[st.gid[hit]] = True

        raster.walk(proj, tiles, trans_eps, visit)
        nonzero, weighted, isects = counts.tolist()
    return {"nonzero": nonzero, "weighted": weighted, "isects": isects,
            "gaussians": int(seen.sum()), "pixels": width * height}


def normalize(num: torch.Tensor, den: torch.Tensor, rnd=identity) -> torch.Tensor:
    """num / den, L2-normalised per row, 0 where undefined."""
    num, den = rnd(num), rnd(den)
    f = rnd(num / (den[:, None] + 1e-12))
    f = rnd(f / rnd(torch.linalg.vector_norm(f, dim=-1, keepdim=True)))
    return torch.nan_to_num(f, nan=0.0, posinf=0.0, neginf=0.0)
