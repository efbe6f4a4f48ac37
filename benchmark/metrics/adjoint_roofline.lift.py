"""B2's share of its roofline in the lift: the counted work's least time (`counts/rooflines.py::adjoint`) over B2's time in the traced job."""

from benchmark import harness

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lift_views_per_s"


def read(ctx):
    return harness.roofline_pct(ctx, "lift", "adjoint")
