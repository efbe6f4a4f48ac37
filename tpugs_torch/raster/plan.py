"""Per-view tile plan, sized exactly. Counterpart:
``tpugs/raster/pallas_tiled.py:265-598`` (``_plan_build``) and ``:175``
(``_sort_by_tile_rank``).

Plain torch, as XLA glue was in ``tpugs``. The steps, in the reference's
order and f32 arithmetic:

1. depth order: a stable argsort of depth, ``+inf`` for invalid Gaussians;
2. tile rectangles (``tile_bbox``) expanded row-major per Gaussian with an
   exclusive cumsum and ``repeat_interleave`` (one host sync for the total);
3. the sub-cutoff ellipse cull (``qmin <= sig_cut + 1e-3``), same f32
   expression as ``pallas_tiled.py:357-396``;
4. a sort by (tile, depth rank);
5. per-tile spans padded to ``BLOCK`` Gaussians, ``padded_gid``;
6. each Gaussian's intersection positions in increasing tile order, stored
   CSR-style by original Gaussian index. They replace the reference's
   cover-major slot table (same entries, same order).

Sizes are exact per view, so nothing is truncated: the reference's static
buckets, size classes and overflow audit have no counterpart here. A plan
whose indices would not fit int32 raises.
"""

from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.raster.binning import tile_bbox, tile_grid
from tpugs_torch.raster.projection import Projected

BLOCK = 128  # Gaussians per kernel block
_I32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Plan:
    order: torch.Tensor  # (N,) int64 depth rank -> original Gaussian index
    padded_gid: torch.Tensor  # (T_padded,) int32 depth rank per padded slot; N = padding
    tile_starts: torch.Tensor  # (n_tiles,) int32 span starts in the sorted list
    tile_ends: torch.Tensor  # (n_tiles,) int32
    padded_starts: torch.Tensor  # (n_tiles,) int32, multiples of BLOCK
    gauss_offsets: torch.Tensor  # (N+1,) int32 CSR offsets by original index
    gauss_pos: torch.Tensor  # (n_isects,) int32 padded row per intersection
    T_padded: int
    n_isects: int
    width: int
    height: int
    tile_size: int

    @property
    def grid(self):
        return tile_grid(self.width, self.height, self.tile_size)

    @property
    def n_tiles(self) -> int:
        ntx, nty = self.grid
        return ntx * nty

    @property
    def num_gaussians(self) -> int:
        return self.order.shape[0]


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(x, 0)
    return c - x


def build_plan(proj: Projected, width: int, height: int, tile_size: int) -> Plan:
    dev = proj.means2d.device
    n = proj.means2d.shape[0]
    ntx, nty = tile_grid(width, height, tile_size)
    n_tiles = ntx * nty
    i64 = dict(dtype=torch.int64, device=dev)

    # 1. depth order (the reference's argsort is stable)
    inf = torch.full_like(proj.depths, float("inf"))
    order = torch.sort(
        torch.where(proj.valid, proj.depths, inf), stable=True
    ).indices
    m2d = proj.means2d[order]
    conics = proj.conics[order]
    sig_cut = proj.sig_cut[order]
    tx0, ty0, tx1, ty1 = tile_bbox(
        m2d, proj.radii[order], proj.valid[order], tile_size, ntx, nty
    )
    w = (tx1 - tx0).long()
    cnt = w * (ty1 - ty0).long()
    w_safe = torch.clamp(w, min=1)

    # 2. row-major expansion of every rectangle, in depth-rank order
    total = int(cnt.sum())
    rank = torch.repeat_interleave(torch.arange(n, **i64), cnt, output_size=total)
    j = torch.arange(total, **i64) - _excl_cumsum(cnt)[rank]
    jx = j % w_safe[rank]
    jy = j // w_safe[rank]
    gx = tx0[rank].long() + jx
    gy = ty0[rank].long() + jy

    # 3. exact sub-cutoff cull: min of the conic quadratic over the tile
    #    rectangle against ln(255*op) (pallas_tiled.py:357-396)
    ts = float(tile_size)
    x0 = gx.to(torch.float32) * ts
    y0 = gy.to(torch.float32) * ts
    mx, my = m2d[rank, 0], m2d[rank, 1]
    ca, cb, cc = conics[rank, 0], conics[rank, 1], conics[rank, 2]
    lx = x0 - mx
    ux = lx + ts
    ly = y0 - my
    uy = ly + ts
    inside = (lx <= 0.0) & (ux >= 0.0) & (ly <= 0.0) & (uy >= 0.0)
    ca_s = torch.clamp(ca, min=1e-12)
    cc_s = torch.clamp(cc, min=1e-12)

    def edge_x(dxe):
        dye = torch.clamp(-cb * dxe / cc_s, min=ly, max=uy)
        return (0.5 * ca) * dxe * dxe + (0.5 * cc) * dye * dye + cb * dxe * dye

    def edge_y(dye):
        dxe = torch.clamp(-cb * dye / ca_s, min=lx, max=ux)
        return (0.5 * ca) * dxe * dxe + (0.5 * cc) * dye * dye + cb * dxe * dye

    qmin = torch.minimum(
        torch.minimum(edge_x(lx), edge_x(ux)),
        torch.minimum(edge_y(ly), edge_y(uy)),
    )
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    keep = torch.nonzero(qmin <= sig_cut[rank] + 1e-3).squeeze(1)
    rank = rank[keep]
    tid = (gy * ntx + gx)[keep]
    n_isects = rank.shape[0]

    # 4. sort by (tile, depth rank); keys are unique
    perm = torch.sort(tid * max(n, 1) + rank).indices
    tid_s = tid[perm]

    # 5. spans, block padding, padded_gid
    spans = torch.bincount(tid_s, minlength=n_tiles)
    tile_ends = torch.cumsum(spans, 0)
    tile_starts = tile_ends - spans
    padded_spans = (spans + BLOCK - 1) // BLOCK * BLOCK
    padded_starts = _excl_cumsum(padded_spans)
    T_padded = int(padded_spans.sum())
    if T_padded > _I32_MAX or n >= _I32_MAX:
        raise ValueError(
            f"plan needs {T_padded} padded slots for {n} Gaussians; "
            "int32 indices overflow"
        )
    pos_sorted = padded_starts[tid_s] + (
        torch.arange(n_isects, **i64) - tile_starts[tid_s]
    )
    padded_gid = torch.full((T_padded,), n, dtype=torch.int32, device=dev)
    padded_gid[pos_sorted] = rank[perm].to(torch.int32)

    # 6. per-Gaussian positions, CSR by original index. Kept entries are
    #    rank-major and in increasing tile order within a rank.
    pos_entry = torch.empty_like(pos_sorted)
    pos_entry[perm] = pos_sorted
    per_rank = torch.bincount(rank, minlength=n)
    per_orig = torch.zeros(n, **i64)
    per_orig[order] = per_rank
    offsets = torch.zeros(n + 1, **i64)
    offsets[1:] = torch.cumsum(per_orig, 0)
    dest = offsets[order[rank]] + (
        torch.arange(n_isects, **i64) - _excl_cumsum(per_rank)[rank]
    )
    gauss_pos = torch.empty(n_isects, dtype=torch.int32, device=dev)
    gauss_pos[dest] = pos_entry.to(torch.int32)

    i32 = torch.int32
    return Plan(
        order=order,
        padded_gid=padded_gid,
        tile_starts=tile_starts.to(i32),
        tile_ends=tile_ends.to(i32),
        padded_starts=padded_starts.to(i32),
        gauss_offsets=offsets.to(i32),
        gauss_pos=gauss_pos,
        T_padded=T_padded,
        n_isects=n_isects,
        width=width,
        height=height,
        tile_size=tile_size,
    )
