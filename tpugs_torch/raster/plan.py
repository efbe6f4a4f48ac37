"""Per-view tile plan, sized exactly. Counterpart:
``tpugs/raster/pallas_tiled.py:265-598`` (``_plan_build``) and ``:175``
(``_sort_by_tile_rank``).

Plain torch, as XLA glue was in ``tpugs``. The steps, in the reference's
order and f32 arithmetic:

1. depth order: a stable argsort of depth, ``+inf`` for invalid Gaussians;
2. tile rectangles (``tile_bbox``) expanded row-major per Gaussian with an
   exclusive cumsum and ``repeat_interleave`` (one host sync for the total);
3. the sub-cutoff ellipse cull (``binning.tile_cut_mask`` without its
   magnitude slack: ``qmin <= sig_cut + 1e-3``, the f32 expression of
   ``pallas_tiled.py:357-396``);
4. a sort by (tile, depth rank);
5. per-tile spans padded to ``BLOCK`` Gaussians, ``padded_gid``;
6. each Gaussian's intersection positions in increasing tile order, stored
   CSR-style by original Gaussian index. They replace the reference's
   cover-major slot table (same entries, same order).

Sizes are exact per view, so nothing is truncated: the reference's static
buckets, size classes and overflow audit have no counterpart here. A plan
whose indices would not fit int32 raises.

With ``scatter=True`` the plan also carries the striped layout of the
opt-in scatter reduce engine (``with_scatter_extras``; counterpart
``pallas_tiled.py:476-525`` and ``_striped_layout`` :1656), built from the
CSR lists above: nothing new is binned.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from tpugs_torch.raster.binning import tile_bbox, tile_cut_mask, tile_grid
from tpugs_torch.raster.projection import Projected
from tpugs_torch.utils.profiling import annotation

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
    # Scatter extras (``scatter=True``), None otherwise. Column c of the
    # striped layout is Gaussian slot_order[c]; cover row j of column c
    # lives at striped row stripe_base[j] + c; row R_striped is the trash
    # row of padding slots.
    slot_order: Optional[torch.Tensor] = None  # (N,) int64 column -> original index
    culled: Optional[torch.Tensor] = None  # (N,) int32 kept intersections per column
    stripe_base: Optional[torch.Tensor] = None  # (max culled,) int32 first row of stripe j
    slot_pos: Optional[torch.Tensor] = None  # (T_padded,) int32 striped row per padded slot
    R_striped: int = 0

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


PLAN_STAGES = ("plan/bboxes+cull", "plan/sort", "plan/slot table", "plan/csr")


def build_plan(
    proj: Projected, width: int, height: int, tile_size: int, scatter: bool = False,
    on_stage: Optional[Callable[[str], None]] = None,
) -> Plan:
    """The exact plan of one view; ``scatter=True`` adds the striped
    layout of the scatter reduce engine (``with_scatter_extras``).
    ``on_stage(name)`` is called after each of ``PLAN_STAGES``: steps 1-3,
    4, 5 and 6 (for timing). Those steps are also the trace's spans
    ``tpugs.plan.cull``, ``sort``, ``slots`` and ``csr``, and each host read
    of the device in them a ``tpugs.sync.plan_*`` span: the expansion's
    total, the kept list, the two bincounts (each reads its input's range)
    and the padded total."""
    mark = on_stage or (lambda name: None)
    dev = proj.means2d.device
    n = proj.means2d.shape[0]
    ntx, nty = tile_grid(width, height, tile_size)
    n_tiles = ntx * nty
    i64 = dict(dtype=torch.int64, device=dev)

    with annotation("tpugs.plan.cull"):
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
        with annotation("tpugs.sync.plan_total"):
            total = int(cnt.sum())
        rank = torch.repeat_interleave(torch.arange(n, **i64), cnt, output_size=total)
        j = torch.arange(total, **i64) - _excl_cumsum(cnt)[rank]
        jx = j % w_safe[rank]
        jy = j // w_safe[rank]
        gx = tx0[rank].long() + jx
        gy = ty0[rank].long() + jy

        # 3. exact sub-cutoff cull: min of the conic quadratic over the tile
        #    rectangle against ln(255*op) (pallas_tiled.py:357-396, which has
        #    no magnitude slack)
        keep = tile_cut_mask(m2d[rank], conics[rank], sig_cut[rank], gx[:, None], gy[:, None],
                             tile_size, magnitude_slack=False)
        with annotation("tpugs.sync.plan_keep"):
            keep = torch.nonzero(keep[:, 0]).squeeze(1)
        rank = rank[keep]
        tid = (gy * ntx + gx)[keep]
        n_isects = rank.shape[0]
    mark("plan/bboxes+cull")

    with annotation("tpugs.plan.sort"):
        # 4. sort by (tile, depth rank); keys are unique
        perm = torch.sort(tid * max(n, 1) + rank).indices
        tid_s = tid[perm]
    mark("plan/sort")

    with annotation("tpugs.plan.slots"):
        # 5. spans, block padding, padded_gid
        with annotation("tpugs.sync.plan_spans"):
            spans = torch.bincount(tid_s, minlength=n_tiles)
        tile_ends = torch.cumsum(spans, 0)
        tile_starts = tile_ends - spans
        padded_spans = (spans + BLOCK - 1) // BLOCK * BLOCK
        padded_starts = _excl_cumsum(padded_spans)
        with annotation("tpugs.sync.plan_padded"):
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
    mark("plan/slot table")

    with annotation("tpugs.plan.csr"):
        # 6. per-Gaussian positions, CSR by original index. Kept entries are
        #    rank-major and in increasing tile order within a rank.
        pos_entry = torch.empty_like(pos_sorted)
        pos_entry[perm] = pos_sorted
        with annotation("tpugs.sync.plan_ranks"):
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
    mark("plan/csr")

    i32 = torch.int32
    plan = Plan(
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
    return with_scatter_extras(plan) if scatter else plan


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def scatter_columns(plan: Plan) -> torch.Tensor:
    """(N,) int64: the striped column of each original Gaussian, the
    inverse of ``plan.slot_order``."""
    return _inverse(plan.slot_order)


def slot_columns(plan: Plan):
    """(slot_order (N,) int64, culled (N,) int64): the columns of the
    cover-major slot table, a stable sort of the Gaussians by descending
    kept-intersection count (their CSR lengths), and those counts in
    column order. The striped layout and the XLA reduce engine
    (``raster/reduce.py``) share them."""
    off = plan.gauss_offsets.long()
    per_orig = off[1:] - off[:-1]
    slot_order = torch.sort(-per_orig, stable=True).indices
    return slot_order, per_orig[slot_order]


def with_scatter_extras(plan: Plan) -> Plan:
    """``plan`` with the striped layout of the scatter engine:

    * ``culled``: each Gaussian's kept-intersection count, its CSR length
      (the reference's compacted culled cover, ``pallas_tiled.py:441-459``),
      in column order;
    * ``slot_order``: the column order, a stable sort by descending kept
      count. The reference sorts by bbox count (``:333``) and sizes each
      cover row by static caps; sorting by the kept count makes the exact
      caps ``cap[j] = #{c : culled[c] > j}`` a prefix of the columns, so
      they never increase with j and leave no holes;
    * ``stripe_base``: cover row j's first striped row, the exclusive
      cumsum of the caps each padded to a multiple of ``BLOCK``
      (``_striped_layout``, with no static ``cover_caps``); ``R_striped``
      is their total;
    * ``slot_pos``: the inverse map. The j-th CSR entry of column c's
      Gaussian goes to ``stripe_base[j] + c``; every other padded slot to
      the trash row ``R_striped``. Caps are exact, so no real entry can
      fall outside its stripe (the reference's ``:511`` has no such
      clamp).

    Cost: a sort of N, a scatter of n_isects and one host sync (the number
    of stripes and ``R_striped``)."""
    dev = plan.gauss_offsets.device
    n = plan.num_gaussians
    i64 = dict(dtype=torch.int64, device=dev)
    off = plan.gauss_offsets.long()
    per_orig = off[1:] - off[:-1]
    slot_order, culled = slot_columns(plan)
    # Columns are sorted by descending count, so a 128-column block is
    # live in stripe j iff its first column is, and the padded cap of
    # stripe j is BLOCK x #{blocks b : culled[BLOCK * b] > j}.
    leads = culled[::BLOCK]
    sizes = torch.stack([culled[:1].sum(), leads.sum() * BLOCK])
    with annotation("tpugs.sync.plan_stripes"):
        n_stripes, r_striped = sizes.tolist()  # the one host sync
    if r_striped + 1 > _I32_MAX:
        raise ValueError(
            f"striped layout needs {r_striped + 1} rows; int32 indices overflow"
        )
    lead_hist = torch.zeros(n_stripes + 1, **i64).scatter_add_(
        0, leads, torch.ones_like(leads)
    )
    blocks_live = leads.shape[0] - torch.cumsum(lead_hist, 0)[:n_stripes]
    stripe_base = _excl_cumsum(blocks_live * BLOCK)

    column = _inverse(slot_order)
    owner = torch.repeat_interleave(torch.arange(n, **i64), per_orig,
                                    output_size=plan.n_isects)
    j = torch.arange(plan.n_isects, **i64) - off[owner]
    slot_pos = torch.full((plan.T_padded,), r_striped, dtype=torch.int32, device=dev)
    slot_pos[plan.gauss_pos.long()] = (stripe_base[j] + column[owner]).to(torch.int32)
    return dataclasses.replace(
        plan,
        slot_order=slot_order,
        culled=culled.to(torch.int32),
        stripe_base=stripe_base.to(torch.int32),
        slot_pos=slot_pos,
        R_striped=r_striped,
    )
