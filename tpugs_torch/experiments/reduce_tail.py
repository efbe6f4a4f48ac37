"""S2 — where does the reduce's time go? Counterpart:
``scripts/exp_reduce_tail.py`` (``_gather_and_stripe`` :53 and its
passes), which split the reference's default reduce into the slot-table
row gather, the stripe-sum kernel and the unpermute to original order.

The port's default reduce (B3) gathers and sums in one pass, so the split
is taken on the scatter engine's striped layout. On one view's real
contribution rows (B2's, in plan order) and its plan with the scatter
extras:

  gather-only       ``rows[src]`` into the striped layout (``src`` is the
                    inverse of ``plan.slot_pos``)
  stripe            that gather, then B7 (``reduce_striped``) in column
                    order: ``_gather_and_stripe``'s function
  stripe+unpermute  the same, then a torch index back to original order
                    over the D+1 columns the lift reads (the reference's
                    ``slice-unperm``); bit-equal to B3
  scatter-acc       the stripe, then ``index_add_`` into an (N, D+1)
                    accumulator (the reference's ``scatter-acc``); on the
                    card its float atomics flush subnormal sums to zero
  full              B3 (``reduce_rows``)

The reference's ``bf16-unperm`` is not ported (``NOT_APPLICABLE``).

On the card::

    python -m tpugs_torch.experiments.reduce_tail

runs the canonical view (N = 2^19, 1296 x 840, D = 512, tile 32, bf16
rows, linear encoder) and prints each pass's time.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

import torch

from tpugs_torch.raster.kernels import reduce_rows, reduce_striped
from tpugs_torch.raster.plan import Plan, scatter_columns

NOT_APPLICABLE = {
    "bf16-unperm": (
        "a lane-padding question of the TPU: there the unpermute was a "
        "row-rate-bound gather of 640-lane f32 rows and bf16 halved its bytes; "
        "here the stripe sum writes only the D+1 columns read, and rounding the "
        "f32 sums to bf16 would change the result the lift accumulates"),
}


def stripe_sources(plan: Plan) -> torch.Tensor:
    """(R_striped + 1,) int64: the plan row that belongs at each striped
    row. Rows that the stripe sum never reads (past a column's count, and
    the trash row) take row 0."""
    src = torch.zeros(plan.R_striped + 1, dtype=torch.int64, device=plan.slot_pos.device)
    real = plan.gauss_pos.long()
    src[plan.slot_pos.long()[real]] = real
    return src


def passes(rows: torch.Tensor, plan: Plan, n_cols: int) -> Dict[str, Callable[[], torch.Tensor]]:
    """The passes on ``rows`` (T_padded, width) of a plan with the scatter
    extras, each a no-argument callable (in the order the reference prints
    them)."""
    src = stripe_sources(plan)
    column = scatter_columns(plan)

    def stripe():
        return reduce_striped(rows[src], plan, n_cols, unpermute=False)

    def scatter_acc():
        out = torch.zeros((plan.num_gaussians, n_cols), dtype=torch.float32,
                          device=rows.device)
        return out.index_add_(0, plan.slot_order, stripe())

    return {
        "gather-only": lambda: rows[src],
        "stripe": stripe,
        "stripe+unpermute": lambda: stripe()[column],
        "scatter-acc": scatter_acc,
        "full": lambda: reduce_rows(rows, plan, n_cols),
    }


def pass_bytes(plan: Plan, width: int, n_cols: int, itemsize: int) -> Dict[str, int]:
    """Bytes each pass must move (each input read once, each output
    written once): the gather reads and writes R_striped + 1 rows of
    ``width`` and reads their int64 sources; B7 reads the live rows'
    ``n_cols`` and ``culled`` and writes N f32 sums; the unpermute reads and
    writes the sums and reads the int64 index; ``index_add_`` also reads
    the accumulator; B3 reads the live rows and their int32 positions."""
    n, n_isects = plan.num_gaussians, plan.n_isects
    r = plan.R_striped + 1
    gather = r * (2 * width * itemsize + 8)
    sums = n * n_cols * 4
    stripe = gather + n_isects * n_cols * itemsize + n * 4 + sums
    return {
        "gather-only": gather,
        "stripe": stripe,
        "stripe+unpermute": stripe + 2 * sums + n * 8,
        "scatter-acc": stripe + 3 * sums + n * 8,
        "full": n_isects * (n_cols * itemsize + 4) + n * 4 + sums,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from tpugs_torch.encoders.base import LinearRGBEncoder
    from tpugs_torch.lift.batch import run_view
    from tpugs_torch.raster.plan import with_scatter_extras
    from tpugs_torch.utils.synthetic import orbit_cameras, random_scene
    from tpugs_torch.utils.timing import time_cuda

    n, w, h, d = 2**19, 1296, 840, 512
    scene = random_scene(n, seed=0, extent=1.0, scale_range=(0.004, 0.02))
    cams = orbit_cameras(8, w, h, radius=3.0)
    r = run_view(scene, cams.viewmats[0], cams.Ks[0], w, h, LinearRGBEncoder(d), 32)
    plan = with_scatter_extras(r.plan)
    print(f"device: {torch.cuda.get_device_name(0)}; T_padded={plan.T_padded} "
          f"intersections={plan.n_isects} R_striped={plan.R_striped} "
          f"stripes={plan.stripe_base.shape[0]}", flush=True)
    fns = passes(r.rows, plan, d + 1)
    for name, fn in fns.items():
        print(f"{name:17s} -> {time_cuda(fn, args.iters):.3f} ms", flush=True)
    for name, why in NOT_APPLICABLE.items():
        print(f"{name:17s} -> not applicable: {why}", flush=True)
    same = torch.equal(fns["stripe+unpermute"](), fns["full"]())
    print(f"stripe+unpermute bit-equal to B3: {same}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
