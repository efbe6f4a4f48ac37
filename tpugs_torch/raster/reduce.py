"""The XLA reduce engine: per-Gaussian sums of contribution rows by a
slot-table gather. Counterpart: ``tpugs/raster/pallas_tiled.py:2029-2110``
(``reduce_contribs``), plain torch: it is the port of an XLA function,
not of a kernel, and has no twin.

The slot table is cover-major: column c is Gaussian ``slot_order[c]``
(columns by descending kept-intersection count, ``plan.slot_columns``),
row j holds each column's j-th intersection row. Its real entries in row
j form a prefix of ``cap[j] = #{c : culled[c] > j}`` columns; the plan's
caps are exact, so no entry is a dummy. Adjacent rows with equal caps are
gathered together and summed over the rows in f32, each group bounded to
``MAX_ROWS`` gathered rows, and the groups are added into the
accumulator in row order, as the reference does; the result is
unpermuted to original Gaussian order.
"""

from __future__ import annotations

import torch

from tpugs_torch.raster.plan import Plan, slot_columns

MAX_ROWS = 1_250_000  # gathered rows per group (the reference's bound)


def reduce_contribs_xla(rows: torch.Tensor, plan: Plan, n_cols: int) -> torch.Tensor:
    """(N, n_cols) float32 sums of each Gaussian's rows of ``rows``
    (T_padded, >= n_cols), any float dtype, in original Gaussian order."""
    n = plan.num_gaussians
    dev = rows.device
    slot_order, culled = slot_columns(plan)
    acc = torch.zeros((n, n_cols), dtype=torch.float32, device=dev)
    if plan.n_isects == 0:
        return acc
    cover = int(culled[0])
    caps = torch.searchsorted(-culled, -torch.arange(cover, device=dev), side="left")
    caps = caps.tolist()  # cap[j] = #{c : culled[c] > j}
    first = plan.gauss_offsets.long()[slot_order]  # each column's first CSR entry
    pos = plan.gauss_pos.long()
    j = 0
    while j < cover:
        j1 = j + 1
        while j1 < cover and caps[j1] == caps[j] and (j1 + 1 - j) * caps[j] <= MAX_ROWS:
            j1 += 1
        cap = caps[j]
        k = torch.arange(j, j1, device=dev)
        flat = pos[(first[None, :cap] + k[:, None]).reshape(-1)]
        block = rows[flat, :n_cols].reshape(j1 - j, cap, n_cols)
        acc[:cap] += block.sum(0, dtype=torch.float32)
        j = j1
    out = torch.empty_like(acc)
    out[slot_order] = acc
    return out
