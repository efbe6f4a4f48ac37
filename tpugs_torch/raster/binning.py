"""Tile grid, per-Gaussian tile rectangles, the exact ellipse cut and the
static-shaped tile binning. Counterpart: ``tpugs/raster/binning.py``
(``cdiv``, ``tile_grid``, ``tile_bbox`` :34-64, ``tile_cut_mask`` :67,
``culled_covers`` :140, ``TileBinning`` and ``build_tile_binning``
:170-247, ``bucket`` :249).

The port's renderers walk the exact per-view ``raster/plan.py::Plan``,
which keeps the same intersections through ``tile_cut_mask``;
``build_tile_binning`` is the reference's static-shaped list (every
Gaussian expanded to ``max_cover`` slots, sentinels sorted last), kept
for callers that read it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpugs_torch.raster.projection import Projected


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_grid(width: int, height: int, tile_size: int) -> Tuple[int, int]:
    return cdiv(width, tile_size), cdiv(height, tile_size)


def tile_bbox(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    valid: torch.Tensor,
    tile_size: int,
    n_tiles_x: int,
    n_tiles_y: int,
):
    """Inclusive-exclusive tile rectangle [tx0, tx1) x [ty0, ty1) covered by
    each Gaussian's radius square; invalid or zero-radius Gaussians cover
    nothing. Returns four int32 tensors."""
    x, y = means2d[..., 0], means2d[..., 1]
    r = radii
    ts = float(tile_size)

    def clip(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    tx0 = clip(torch.floor((x - r) / ts), n_tiles_x)
    ty0 = clip(torch.floor((y - r) / ts), n_tiles_y)
    tx1 = clip(torch.floor((x + r) / ts) + 1, n_tiles_x)
    ty1 = clip(torch.floor((y + r) / ts) + 1, n_tiles_y)
    empty = ~valid | (r <= 0)
    tx1 = torch.where(empty, tx0, tx1)
    ty1 = torch.where(empty, ty0, ty1)
    return tx0, ty0, tx1, ty1


def tile_cut_mask(
    means2d: torch.Tensor,  # (..., 2)
    conics: torch.Tensor,  # (..., 3) inverse-covariance upper triangle (a, b, c)
    sig_cut: torch.Tensor,  # (...,) sigma threshold ln(255*op); -1 if invalid
    tx: torch.Tensor,  # (..., K) candidate tile x indices
    ty: torch.Tensor,  # (..., K)
    tile_size: int,
    magnitude_slack: bool = True,
) -> torch.Tensor:
    """(..., K) False where every pixel of tile (tx, ty) is provably below
    the 1/255 alpha clip for the Gaussian: the exact minimum of the conic
    quadratic 0.5*(a dx^2 + c dy^2) + b dx dy over the tile rectangle (0 if
    the mean is inside, else the least of the four clamped edge minima)
    exceeds ``sig_cut`` + 1e-3. With ``magnitude_slack`` the bound also
    gains 32 f32 epsilons of the edge terms' magnitudes, as the reference's
    tiled binning does; the Pallas planner (``pallas_tiled.py:357-396``,
    the port's ``build_plan``) has no such term."""
    ts = float(tile_size)
    x0 = tx.to(torch.float32) * ts
    y0 = ty.to(torch.float32) * ts
    mx, my = means2d[..., 0:1], means2d[..., 1:2]
    a, b, c = conics[..., 0:1], conics[..., 1:2], conics[..., 2:3]
    lx = x0 - mx
    ux = lx + ts
    ly = y0 - my
    uy = ly + ts
    inside = (lx <= 0.0) & (ux >= 0.0) & (ly <= 0.0) & (uy >= 0.0)
    a_s = torch.clamp(a, min=1e-12)
    c_s = torch.clamp(c, min=1e-12)

    def terms(dx, dy):
        return (0.5 * a) * dx * dx, (0.5 * c) * dy * dy, b * dx * dy

    def edge_x(dx):  # min over dy in [ly, uy] at fixed dx
        return terms(dx, torch.clamp(-b * dx / c_s, min=ly, max=uy))

    def edge_y(dy):
        return terms(torch.clamp(-b * dy / a_s, min=lx, max=ux), dy)

    edges = [edge_x(lx), edge_x(ux), edge_y(ly), edge_y(uy)]
    q = [t1 + t2 + t3 for t1, t2, t3 in edges]
    qmin = torch.minimum(torch.minimum(q[0], q[1]), torch.minimum(q[2], q[3]))
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    bound = sig_cut[..., None] + 1e-3
    if magnitude_slack:
        m = [t1.abs() + t2.abs() + t3.abs() for t1, t2, t3 in edges]
        mmax = torch.maximum(torch.maximum(m[0], m[1]), torch.maximum(m[2], m[3]))
        bound = bound + 32.0 * torch.finfo(torch.float32).eps * mmax
    return qmin <= bound


def _cover_slots(tx0, ty0, tx1, ty1, max_cover: int):
    """Row-major slots j < max_cover of each rectangle: (tx, ty, in rect)."""
    w = tx1 - tx0
    cnt = w * (ty1 - ty0)
    j = torch.arange(max_cover, dtype=torch.int32, device=tx0.device)
    w_safe = torch.clamp(w, min=1)
    jx = j[None, :] % w_safe[:, None]
    jy = j[None, :] // w_safe[:, None]
    return tx0[:, None] + jx, ty0[:, None] + jy, j[None, :] < cnt[:, None], cnt


def culled_covers(proj: Projected, tile_size: int, width: int, height: int,
                  max_cover: int):
    """Per Gaussian (bbox cover, culled cover): the candidate tiles of its
    radius rectangle, and how many of the first ``max_cover`` survive
    ``tile_cut_mask``. int32 (N,) each."""
    ntx, nty = tile_grid(width, height, tile_size)
    tx0, ty0, tx1, ty1 = tile_bbox(proj.means2d, proj.radii, proj.valid, tile_size, ntx, nty)
    tx, ty, sv, cnt = _cover_slots(tx0, ty0, tx1, ty1, max_cover)
    sv &= tile_cut_mask(proj.means2d, proj.conics, proj.sig_cut, tx, ty, tile_size)
    return cnt, sv.sum(1, dtype=torch.int32)


class TileBinning(NamedTuple):
    order: torch.Tensor  # (N,) int64 depth-sort permutation (front first)
    sorted_gid: torch.Tensor  # (N*max_cover,) int32 depth ranks; sentinels == N, last
    tile_starts: torch.Tensor  # (n_tiles + 1,) int32 span offsets into sorted_gid
    max_span: torch.Tensor  # () int32 longest per-tile list
    max_cover_req: torch.Tensor  # () int32 true max tiles per Gaussian
    n_isects: torch.Tensor  # () int32 real intersections


def build_tile_binning(proj: Projected, tile_size: int, width: int, height: int,
                       max_cover: int) -> TileBinning:
    """Depth order, each Gaussian's first ``max_cover`` bbox tiles that
    survive ``tile_cut_mask``, one sort by (tile, depth rank), and the
    spans by ``searchsorted``; a Gaussian covering more than ``max_cover``
    tiles loses the rest (``max_cover_req`` tells)."""
    dev = proj.means2d.device
    ntx, nty = tile_grid(width, height, tile_size)
    n_tiles = ntx * nty
    n = proj.means2d.shape[0]
    inf = torch.full_like(proj.depths, float("inf"))
    order = torch.sort(torch.where(proj.valid, proj.depths, inf), stable=True).indices
    tx0, ty0, tx1, ty1 = tile_bbox(proj.means2d[order], proj.radii[order],
                                   proj.valid[order], tile_size, ntx, nty)
    tx, ty, sv, cnt = _cover_slots(tx0, ty0, tx1, ty1, max_cover)
    sv &= tile_cut_mask(proj.means2d[order], proj.conics[order], proj.sig_cut[order],
                        tx, ty, tile_size)
    tid = torch.where(sv, ty * ntx + tx, n_tiles).long().reshape(-1)
    gid = torch.arange(n, device=dev)[:, None].expand(n, max_cover)
    gid = torch.where(sv, gid, n).reshape(-1)
    key = tid * (n + 1) + gid  # (tid, gid) pairs of real slots are unique
    sorted_key = torch.sort(key).values
    tid_s, gid_s = sorted_key // (n + 1), sorted_key % (n + 1)
    tile_starts = torch.searchsorted(
        tid_s, torch.arange(n_tiles + 1, device=dev), side="left").to(torch.int32)
    spans = tile_starts[1:] - tile_starts[:-1]
    i32 = torch.int32
    return TileBinning(
        order=order,
        sorted_gid=gid_s.to(i32),
        tile_starts=tile_starts,
        max_span=spans.max().to(i32) if n_tiles else torch.zeros((), dtype=i32, device=dev),
        max_cover_req=cnt.max().to(i32) if n else torch.zeros((), dtype=i32, device=dev),
        n_isects=tile_starts[-1],
    )


def bucket(value: int, minimum: int = 1) -> int:
    """Round up to the next power of two."""
    v = max(int(value), minimum)
    return 1 << (v - 1).bit_length()
